"""The benchmark's one boundary with the program under test,
``livetalking_tpu_torch``: loading, sessions and counters.

Sessions are made as the server makes them: ``app.load_plugin_stack(opt)``,
``session_manager.create_session`` and ``app.start_render_thread``, with the
``queue`` transport. Weights come from the benchmark's state dicts through
the program's own checkpoint converters (``convert_torch_state_dict`` of
the Whisper encoder, the U-Net and the VAE), into the model dictionary that
``musetalk_avatar.load_model`` builds from checkpoint files; no file is
written. Avatars come from ``musetalk_avatar.avatar_from_arrays``, which
encodes their faces with the program's VAE.
"""

from __future__ import annotations

import asyncio
import contextlib
import importlib
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import torch

PACKAGE = "livetalking_tpu_torch"


def _mod(name: str):
    return importlib.import_module(f"{PACKAGE}.{name}")


class _AsF32(dict):
    """A state dict whose values read as float32 (the converters go
    through numpy, which has no bfloat16)."""

    def __getitem__(self, key):
        return dict.__getitem__(self, key).float()

    def items(self):
        return ((k, v.float()) for k, v in dict.items(self))


def build_kernels() -> None:
    """The program's CUDA kernels, built (first run in a checkout) or found."""
    _mod("ops._build").build_all()


def load_model(cfg: dict, sds: Dict[str, dict], dtype: torch.dtype, device) -> dict:
    we, sd_unet, sd_vae = _mod("models.whisper_encoder"), _mod("models.sd_unet"), _mod("models.sd_vae")
    w, u = cfg["whisper"], cfg["unet"]
    wcfg = we.WhisperConfig(n_mels=w["num_mel_bins"], d_model=w["d_model"],
                            num_layers=w["encoder_layers"], num_heads=w["encoder_attention_heads"],
                            ffn=w["encoder_ffn_dim"], max_positions=w["max_source_positions"])
    ucfg = sd_unet.UNetConfig(in_channels=u["in_channels"], out_channels=u["out_channels"],
                              block_out=tuple(u["block_out_channels"]),
                              layers_per_block=u["layers_per_block"],
                              cross_dim=u["cross_attention_dim"], heads=u["attention_head_dim"],
                              norm_eps=u["norm_eps"])
    dev = torch.device(device)
    return {"whisper_params": we.convert_torch_state_dict(_AsF32(sds["whisper"]), wcfg, dtype, dev),
            "whisper_cfg": wcfg,
            "vae_params": sd_vae.convert_torch_state_dict(_AsF32(sds["vae"]), dtype, dev),
            "unet_params": sd_unet.convert_torch_state_dict(_AsF32(sds["unet"]), ucfg, dtype, dev),
            "unet_cfg": ucfg, "dtype": dtype, "device": dev}


class Served:
    """Running sessions and the program's counters."""

    def __init__(self, app, muse, sessions: List, sids: List[str]):
        self.app, self.muse = app, muse
        self.sessions, self.sids = sessions, sids

    def start(self) -> None:
        """Start every session's render thread: frames flow from now on,
        and the queue transport drops its oldest frame past 100."""
        for sid in self.sids:
            self.app.start_render_thread(sid)

    @property
    def scheduler(self):
        return self.muse._shared["scheduler"]

    @property
    def feature_coalescer(self):
        return self.muse._shared.get("feat_coalescer")

    def counters(self) -> dict:
        """A snapshot of the scheduler's, the feature coalescer's and the
        kernels' counters (the rolling deques as lists)."""
        s, fc = self.scheduler, self.feature_coalescer
        attn, blend, conv = _mod("ops.attention"), _mod("ops.blend"), _mod("ops.conv")
        return {"batches_run": s.batches_run, "requests_run": s.requests_run,
                "requests_submitted": s.requests_submitted, "frames_run": s.frames_run,
                "batch_sizes": list(s.batch_sizes), "latency_s": list(s.latency_s),
                "buckets": list(s.buckets), "batch_size": s.batch_size,
                "feature_batches_run": None if fc is None else fc.batches_run,
                "feature_requests_run": None if fc is None else fc.requests_run,
                "attention_launches": attn.attention.launches,
                "paste_launches": blend.blend_masked_.launches,
                "conv3x3_q_launches": conv.conv3x3_q.launches,
                "conv3x3_gnq_launches": conv.conv3x3_gnq.launches}


@contextlib.contextmanager
def serve(model: dict, program: dict, avatars: List[dict], device, feature_shape):
    """``len(avatars)`` sessions of ``--model musetalk`` with ``program``'s
    flags, each on its own avatar, not yet rendering, the scheduler's
    buckets warmed for features of ``feature_shape``; yields a ``Served``.
    Stops every thread and the shared scheduler on exit."""
    app = _mod("app")
    muse = _mod("avatars.musetalk_avatar")
    sm = _mod("server.session_manager").session_manager
    config = _mod("config")
    ids = [f"ltbench_{k}" for k in range(len(avatars))]
    for avatar_id, a in zip(ids, avatars):
        app.global_avatars[avatar_id] = muse.avatar_from_arrays(
            avatar_id, a["frames"], a["faces"], a["coords"], a["mask_coords"], a["masks"],
            model["vae_params"], device=device)
    opt = config.default_opt(transport="queue", tts="dummy", device=str(device),
                             avatar_id=ids[0], max_session=len(ids), **program)
    saved_load = muse.load_model
    muse.load_model = lambda _opt: model
    sids: List[str] = []
    try:
        app.load_plugin_stack(opt)
        for avatar_id in ids:
            sids.append(asyncio.run(sm.create_session({"avatar": avatar_id})))
        served = Served(app, muse, [sm.get_session(s) for s in sids], sids)
        served.scheduler.prewarm(tuple(feature_shape))
        yield served
    finally:
        for sid in sids:
            sm.get_session(sid).flush_talk()
        with ThreadPoolExecutor(max(1, len(sids))) as pool:
            list(pool.map(lambda sid: app.stop_render_thread(sid, timeout=30), sids))
        for sid in sids:
            sm.remove_session(sid)
        muse.reset_shared_scheduler()
        muse.load_model = saved_load
        for avatar_id in ids:
            app.global_avatars.pop(avatar_id, None)
        app.model = None


def set_env(env: Dict[str, str]) -> None:
    """Set ``env`` in this process (the program reads it at each call)."""
    os.environ.update({k: str(v) for k, v in env.items()})
