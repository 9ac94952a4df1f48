"""MuseTalk composite model: PE + single-step latent U-Net + VAE decode
(ports livetalking_tpu/models/musetalk.py).

Whisper feature chunks (B, 50, 384) get the interleaved sinusoidal
positional encoding, the latent U-Net runs ONE denoise step at t=0 with the
audio as cross-attention context over the 8-channel (masked || reference)
avatar latents, and the VAE decodes the 4-channel prediction to a 256 px
BGR uint8 face. The step runs gather -> PE add -> U-Net -> decode -> uint8
BGR on the device: only B indices go up, and the faces stay there for the
paste-back.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from livetalking_tpu_torch.models import sd_unet, sd_vae
from livetalking_tpu_torch.utils.device import resolve_device


def positional_encoding_table(seq_len: int, d_model: int = 384) -> np.ndarray:
    """Interleaved sin/cos positional encoding, (seq_len, d_model) f32."""
    pe = np.zeros((seq_len, d_model), np.float32)
    pos = np.arange(seq_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-math.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


def make_infer_fn(unet_cfg: sd_unet.UNetConfig, batch_size: int, ctx_len: int = 50,
                  dtype: torch.dtype = torch.bfloat16, vae_int8: bool = False,
                  unet_int8: bool = False):
    """Build the device step:

        (unet_params, vae_params, latent_cycle (N, 32, 32, 8) f32, idxs (B,),
         whisper (B, ctx_len, 384) f32) -> (B, 256, 256, 3) uint8 BGR faces

    on the tensors' device; the parameters must already be there in
    ``dtype`` (``diffusion_blocks.prepare``). ``vae_int8`` / ``unet_int8``
    run the W8A8 decoder / U-Net, whose parameters are then the
    ``quantize_decoder`` / ``quantize_unet`` trees (calibrated)."""
    pe_host = torch.from_numpy(positional_encoding_table(ctx_len, unet_cfg.cross_dim))
    pe_dev = {}
    if vae_int8:
        decode = sd_vae.decode_int8
    else:
        decode = functools.partial(sd_vae.decode, dtype=dtype)
    unet_apply = sd_unet.apply_int8 if unet_int8 else sd_unet.apply

    @torch.inference_mode()
    def step(unet_params, vae_params, latent_cycle, idxs, whisper):
        if whisper.shape[0] != batch_size:
            raise ValueError(f"step built for B={batch_size}, got {whisper.shape[0]} feature rows")
        dev = latent_cycle.device
        pe = pe_dev.get(dev)
        if pe is None:
            pe = pe_dev[dev] = pe_host.to(dev)
        lat = latent_cycle.index_select(0, idxs.to(dev)).to(dtype)
        ctx = (whisper.float() + pe).to(dtype)
        t = torch.zeros((batch_size,), dtype=torch.float32, device=dev)
        pred = unet_apply(unet_params, unet_cfg, lat, t, ctx)  # (B, 32, 32, 4) f32
        img = decode(vae_params, pred.to(dtype))  # (B, 256, 256, 3) RGB in [0, 1]
        u8 = (img * 255.0).round().clamp(0, 255).to(torch.uint8)
        return u8.flip(-1).contiguous()  # RGB -> BGR

    return step



def make_sharded_infer_fn(unet_cfg: sd_unet.UNetConfig, batch_size: int, mesh,
                          ctx_len: int = 50, dtype: torch.dtype = torch.bfloat16):
    """The multi-device step, called alike on every rank of ``mesh``:

        (unet_params, vae_params, latent_cycle, idxs (B,), whisper (B, ctx_len, 384))
            -> (B, 256, 256, 3) uint8 BGR faces, on every rank

    The batch runs over ``dp`` (each rank takes its B/dp rows of ``idxs``
    and ``whisper``), the U-Net's and the VAE's conv channels over ``tp``
    (parameters placed with ``parallel.mesh.shard_params``); the latent
    cycle is whole on every rank. The faces are gathered over dp. Self-
    attention runs kernel 3 unchanged inside every rank's U-Net blocks.
    ``batch_size`` must divide over dp. No int8 route, as in the JAX
    package."""
    from livetalking_tpu_torch.parallel.mesh import DP_AXIS, gather_batch, shard_batch

    dp = mesh.shape[DP_AXIS]
    if batch_size % dp:
        raise ValueError(f"batch {batch_size} not divisible by dp={dp}")
    local = make_infer_fn(unet_cfg, batch_size // dp, ctx_len, dtype)

    @torch.inference_mode()
    def step(unet_params, vae_params, latent_cycle, idxs, whisper):
        if whisper.shape[0] != batch_size:
            raise ValueError(f"step built for B={batch_size}, got {whisper.shape[0]} feature rows")
        faces = local(unet_params, vae_params, latent_cycle, shard_batch(idxs, mesh),
                      shard_batch(whisper, mesh))
        return gather_batch(faces, mesh)

    return step

@torch.inference_mode()
def encode_avatar_latents(vae_params, faces_bgr: np.ndarray, batch: int = 8,
                          device="cuda", dtype: torch.dtype = torch.float32) -> np.ndarray:
    """Per-frame (32, 32, 8) U-Net input latents of an avatar:
    cat(masked-lower-half latents, reference latents), encoded on
    ``device`` (the card unless the caller asks for the CPU).

    faces_bgr: (N, 256, 256, 3) uint8. Returns (N, 32, 32, 8) float32."""
    device = resolve_device(device)
    rgb = faces_bgr[..., ::-1].astype(np.float32) / 255.0
    x = (rgb - 0.5) / 0.5  # [-1, 1]
    half_mask = np.ones((256, 256, 1), np.float32)
    half_mask[128:] = 0.0

    out = []
    for s in range(0, x.shape[0], batch):
        chunk = x[s:s + batch]
        ref = torch.from_numpy(np.ascontiguousarray(chunk)).to(device=device, dtype=dtype)
        masked = torch.from_numpy(np.ascontiguousarray(chunk * half_mask)).to(device=device,
                                                                              dtype=dtype)
        lat_ref = sd_vae.encode(vae_params, ref)
        lat_masked = sd_vae.encode(vae_params, masked)
        out.append(torch.cat([lat_masked, lat_ref], dim=-1).float().cpu().numpy())
    return np.concatenate(out, axis=0)
