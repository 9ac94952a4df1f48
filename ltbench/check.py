"""Whether what the timed path produced is correct, by the plain reference.

After the window, for a sample of the frames the viewers took in it
(``drive``'s reservoir, drawn from the seed), the reference works out each
frame again from what the benchmark itself made: the session's speech (the
audio items the viewer saw name each chunk of the encoder window, silence
where none was queued), the avatar's faces (re-encoded to latents), the
weights, and, on the W8A8 route, the static scales recalibrated from the
same calibration inputs. It then pastes the face into the avatar frame.

Numbers compared, each with its limit from the configuration file (a
number the file gives no limit is printed and not compared):

  - ``worst_frame_mse``: the largest mean squared difference, in 8-bit
    levels over the crop box, of a sampled frame from the float32
    reference's;
  - ``mean_frame_mse``: the same difference's mean over the sampled frames;
  - ``q_worst_frame_mse``, ``q_mean_frame_mse``: the same against the
    reference on the configuration's quantised route, where it has one;
  - ``q_ref_mean_frame_mse``: that quantised reference's own mean
    difference from the float32 reference, on the same frames (how far
    int8's noise alone moves a frame);
  - ``q_ref_ratio``: ``mean_frame_mse`` over ``q_ref_mean_frame_mse``. How
    far int8 moves a frame depends on the frame (on some seeds' faces and
    speech both sides read twice what they read on others), so the program
    is held to the reference's own int8 distance, on the same frames;
  - ``outside_crop_diff_px``: pixel values outside the crop box (below the
    watermark rows) that differ from the avatar frame: exact, limit 0;
  - ``unchecked_sessions``: sessions with no frame that could be checked.

With ``in_place_bits`` under the configuration's ``check`` (its control
run), the frames compared are the reference's at that many bits, on the
same inputs, in the program's place.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ltbench import reference as ref
from ltbench.drive import Observed, mirror_index
from ltbench.traffic import CHUNK, Speech

WATERMARK_ROWS = 32


def _window_pcm(speech: Speech, k: int, items: List[int], j: int, B: int, l: int, r: int):
    """The encoder window of batch ``j``: audio items [2Bj - l, 2Bj + 2B + r)."""
    parts = []
    for p in range(2 * B * j - l, 2 * B * j + 2 * B + r):
        serial = items[p] if p >= 0 else -1
        parts.append(speech.chunk(k, serial) if serial >= 0 else np.zeros(CHUNK, np.float32))
    return np.concatenate(parts)


def plan(obs: Observed, B: int, l: int, r: int) -> List[tuple]:
    """(session, frame ordinal) of every sampled model frame whose encoder
    window the viewer saw whole."""
    out = []
    for k, log in enumerate(obs.logs):
        for n in sorted(log.kept):
            j = n // B
            if len(log.audio) < 2 * B * j + 2 * B + r:
                continue
            if max(log.audio[2 * n], log.audio[2 * n + 1]) >= 0:
                out.append((k, n))
    return out


@torch.inference_mode()
def compare(cfg: dict, sds: Dict[str, dict], avatars: List[dict], obs: Observed, seed: int,
            device, chunk: int = 16) -> Dict[str, dict]:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sv = cfg["serving"]
    B, l, r = cfg["program"]["batch_size"], sv["l"], sv["r"]
    heads = cfg["whisper"]["encoder_attention_heads"]
    whisper = ref.f32_state(sds["whisper"])
    unet, vae = ref.f32_state(sds["unet"]), ref.f32_state(sds["vae"])
    speech = Speech(seed)
    todo = plan(obs, B, l, r)
    bits = int(cfg["reference"].get("quant_bits", 0))
    low_bits = int(cfg["check"].get("in_place_bits", 0))
    quants = {}
    for b in {bits, low_bits} - {0}:
        q = ref.Quant(b)
        a0 = avatars[0]
        faces0 = torch.from_numpy(np.ascontiguousarray(a0["faces"][:4])).to(device)
        lat0 = ref.avatar_latents(vae, faces0)
        ctx0 = ref.calibration_context(whisper, heads, lat0.shape[0], device)
        ref.calibrate(q, unet, cfg["unet"], vae, lat0, ctx0)
        quants[b] = q

    # audio rows per (session, batch), latents per (session, avatar index)
    rows = {}
    for k, n in todo:
        j = n // B
        if (k, j) not in rows:
            pcm = _window_pcm(speech, k, obs.logs[k].audio, j, B, l, r)
            mel = ref.log_mel(torch.from_numpy(pcm).to(device)[None])
            st = ref.whisper_states(whisper, mel, heads)[0]
            rows[(k, j)] = ref.audio_context(st, B, l)
    keys = sorted({(k, mirror_index(len(avatars[k]["frames"]), n)) for k, n in todo})
    lat = {}
    for s in range(0, len(keys), chunk):
        part = keys[s:s + chunk]
        faces = torch.from_numpy(np.stack([avatars[k]["faces"][i] for k, i in part])).to(device)
        for key, v in zip(part, ref.avatar_latents(vae, faces)):
            lat[key] = v

    refs = {"": None}
    if bits:
        refs["q_"] = quants[bits]
    mse = {key: [] for key in refs}
    q_ref = []
    outside = 0
    checked = set()
    for s in range(0, len(todo), chunk):
        part = todo[s:s + chunk]
        L = torch.stack([lat[(k, mirror_index(len(avatars[k]["frames"]), n))] for k, n in part])
        C = torch.stack([rows[(k, n // B)][n - (n // B) * B] for k, n in part])
        want = {key: ref.step_faces(unet, cfg["unet"], vae, L, C, q) for key, q in refs.items()}
        got = (ref.step_faces(unet, cfg["unet"], vae, L, C, quants[low_bits])
               if low_bits else None)
        for b, (k, n) in enumerate(part):
            a = avatars[k]
            idx = mirror_index(len(a["frames"]), n)
            frame = torch.from_numpy(a["frames"][idx]).to(device)
            mask = torch.from_numpy(a["masks"][idx]).to(device)
            box = (a["coords"][idx], a["mask_coords"][idx])
            if got is not None:
                seen = ref.paste(got[b], frame, *box, mask)
            else:
                seen = torch.from_numpy(obs.logs[k].kept[n]).to(device)
            xs, ys, xe, ye = a["mask_coords"][idx]
            pasted = {key: ref.paste(want[key][b], frame, *box, mask).float() for key in refs}
            if bits:
                q_ref.append(float(((pasted["q_"] - pasted[""])[ys:ye, xs:xe] ** 2).mean()))
            for key in refs:
                d = seen.float() - pasted[key]
                mse[key].append(float((d[ys:ye, xs:xe] ** 2).mean()))
            out = d.abs() > 0
            out[ys:ye, xs:xe] = False
            out[:WATERMARK_ROWS] = False
            outside += int(out.sum())
            checked.add(k)
    limits = cfg["check"]["limits"]
    numbers = {}
    for key, v in mse.items():
        for name, value in (("worst_frame_mse", max(v, default=0.0)),
                            ("mean_frame_mse", sum(v) / max(len(v), 1))):
            numbers[key + name] = {"value": value, "limit": limits.get(key + name)}
    if bits:
        q_ref_mean = sum(q_ref) / max(len(q_ref), 1)
        numbers["q_ref_mean_frame_mse"] = {"value": q_ref_mean, "limit": None}
        numbers["q_ref_ratio"] = {"value": numbers["mean_frame_mse"]["value"]
                                  / max(q_ref_mean, 1e-12), "limit": limits.get("q_ref_ratio")}
    numbers.update({
        "outside_crop_diff_px": {"value": outside, "limit": limits["outside_crop_diff_px"]},
        "unchecked_sessions": {"value": len(obs.logs) - len(checked), "limit": 0},
        "frames_checked": {"value": len(todo), "limit": None}})
    return numbers

