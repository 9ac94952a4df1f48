"""Whether what the timed Wav2Lip path produced is correct, by the plain reference.

After the window, for a sample of the frames the viewers took in it
(``drive``'s reservoir, drawn from the seed), the reference works out each
frame again from what the benchmark itself made: the session's speech (the
audio items the viewer saw name each chunk of the feature request's
window, silence where none was queued), the avatar's faces and frames, and
the weights (``ltbench/reference_wav2lip.py``, float32, TF32 off). It then
compares, each number with its limit from the configuration file:

  - ``worst_frame_mse``: the largest mean squared difference, in 8-bit
    levels over the face box, of a sampled frame from the reference's;
  - ``mean_frame_mse``: the same difference's mean over the sampled frames;
  - ``outside_crop_diff_px``: pixel values outside the face box (below the
    watermark rows) that differ from the avatar frame: exact, limit 0;
  - ``unchecked_sessions``: sessions with no frame that could be checked,
    limit 0;

and prints, with no limit, ``frames_checked``, the standard deviation of
the reference's logits (the sigmoid's input) and of its 8-bit face levels
over the sampled frames: how far the check sits from a saturated output.

With ``in_place_bits`` under the configuration's ``check`` (its control
run) the frames compared are the reference's own, on the same inputs, with
each conv's weights and input rounded to that many bits, in the program's
place.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ltbench import reference_wav2lip as ref
from ltbench.check import WATERMARK_ROWS, _window_pcm, plan
from ltbench.drive import Observed, mirror_index
from ltbench.traffic import Speech


def mel_rows(cfg: dict, speech: Speech, items: List[int], k: int, j: int, B: int,
             device) -> torch.Tensor:
    """(B, 1, 80, 16): the mel windows of session ``k``'s request ``j``, from
    the audio items its viewer took (``items``)."""
    sv, mc = cfg["serving"], cfg["mel"]
    pcm = _window_pcm(speech, k, items, j, B, sv["l"], sv["r"])
    spec = ref.log_mel(torch.from_numpy(pcm).to(device), mc)
    return ref.mel_windows(spec, B, sv["l"], sv["fps"], mc["mel_step_size"])[:, None]


@torch.inference_mode()
def compare(cfg: dict, sd: Dict[str, torch.Tensor], avatars: List[dict], obs: Observed,
            seed: int, device, chunk: int = 32) -> Dict[str, dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sv = cfg["serving"]
    B = cfg["program"]["batch_size"]
    sd = ref.f32_state(sd)
    speech = Speech(seed)
    todo = plan(obs, B, sv["l"], sv["r"])
    bits = int(cfg["check"].get("in_place_bits", 0))
    rows = {}
    for k, n in todo:
        if (k, n // B) not in rows:
            rows[(k, n // B)] = mel_rows(cfg, speech, obs.logs[k].audio, k, n // B, B, device)

    mse: List[float] = []
    logits_sq = logits_sum = levels_sq = levels_sum = count = 0.0
    outside = 0
    checked = set()
    for s in range(0, len(todo), chunk):
        part = todo[s:s + chunk]
        idx = [mirror_index(len(avatars[k]["frames"]), n) for k, n in part]
        faces = torch.from_numpy(np.stack([avatars[k]["faces"][i]
                                           for (k, _n), i in zip(part, idx)])).to(device)
        mel = torch.stack([rows[(k, n // B)][n % B] for k, n in part])
        logits = ref.network(sd, cfg, mel, ref.face_input(faces))
        want = ref.faces_u8(logits)
        logits_sum += float(logits.double().sum())
        logits_sq += float((logits.double() ** 2).sum())
        lv = want.double()
        levels_sum += float(lv.sum())
        levels_sq += float((lv ** 2).sum())
        count += logits.numel()
        got = (ref.faces_u8(ref.network(sd, cfg, mel, ref.face_input(faces), bits=bits))
               if bits else None)
        for b, ((k, n), i) in enumerate(zip(part, idx)):
            a = avatars[k]
            frame = torch.from_numpy(np.asarray(a["frames"][i])).to(device)
            x1, y1, x2, y2 = (int(v) for v in a["coords"][i])
            if got is not None:
                seen = ref.paste(got[b], frame, (x1, y1, x2, y2))
            else:
                seen = torch.from_numpy(obs.logs[k].kept[n]).to(device)
            d = seen.float() - ref.paste(want[b], frame, (x1, y1, x2, y2)).float()
            mse.append(float((d[y1:y2, x1:x2] ** 2).mean()))
            out = d.abs() > 0
            out[y1:y2, x1:x2] = False
            out[:WATERMARK_ROWS] = False
            outside += int(out.sum())
            checked.add(k)

    def std(total, sq):
        mean = total / max(count, 1)
        return max(sq / max(count, 1) - mean * mean, 0.0) ** 0.5

    limits = cfg["check"]["limits"]
    return {
        "worst_frame_mse": {"value": max(mse, default=0.0), "limit": limits["worst_frame_mse"]},
        "mean_frame_mse": {"value": sum(mse) / max(len(mse), 1),
                           "limit": limits["mean_frame_mse"]},
        "outside_crop_diff_px": {"value": outside, "limit": limits["outside_crop_diff_px"]},
        "unchecked_sessions": {"value": len(obs.logs) - len(checked), "limit": 0},
        "frames_checked": {"value": len(todo), "limit": None},
        "reference_logit_std": {"value": std(logits_sum, logits_sq), "limit": None},
        "reference_level_std": {"value": std(levels_sum, levels_sq), "limit": None},
    }
