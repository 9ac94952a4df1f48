"""Work of the MuseTalk step, counted from the configuration's shapes.

``step_ops(cfg)`` lists every matrix operation of one served frame (the
U-Net at one timestep, the VAE decode) with its operations, its
precision on the served route and the bytes its kernel must move;
``whisper_ops(cfg)`` does the same for one feature request (one encoder
window). Operations count a multiply-add as two. Elementwise passes
(norms, activations, the quantise passes) carry no operations here.

Bytes follow the kernels' own bounds: each input byte read once and each
output byte written once. For self-attention (kernel 3): q, k, v and o in
bfloat16. For a 3x3 int8 conv (kernel 4): the int8 input, the int8
weights (once a call), the bfloat16 output and any bfloat16 residual; for
the fused GroupNorm-SiLU-quantize conv (kernel 5) the input is bfloat16
(before the in-kernel 2x upsample where there is one) and the kernel also
computes about 8 float32 operations per input element.

``PEAKS`` are one H100 SXM's published dense rates at its 700 W limit.
"""

from __future__ import annotations

import dataclasses
from typing import List

PEAKS = {"bfloat16": 989e12, "int8": 1979e12, "float32": 67e12, "hbm_bytes_per_s": 3.35e12}


@dataclasses.dataclass
class Op:
    name: str
    prec: str            # "bfloat16", "int8" or "float32"
    flops: float         # per frame (per request for whisper_ops)
    group: str = ""      # "attention" (kernel 3), "conv4", "conv5" or ""
    bytes_frame: float = 0.0   # kernel bytes per frame
    bytes_call: float = 0.0    # kernel bytes per call (weights)
    extra_f32: float = 0.0     # float32 elementwise operations per frame (kernel 5)

    def least_s(self, frames: float) -> float:
        """Least time of one call over ``frames`` frames at the peaks."""
        t_ops = frames * self.flops / PEAKS[self.prec]
        t_bytes = (frames * self.bytes_frame + self.bytes_call) / PEAKS["hbm_bytes_per_s"]
        t_f32 = frames * self.extra_f32 / PEAKS["float32"]
        return max(t_ops, t_bytes, t_f32)


def _int8(cfg: dict, key: str) -> bool:
    return bool(cfg["program"].get(key, False))


def _fused_vae(cfg: dict) -> bool:
    return _int8(cfg, "vae_int8") and cfg.get("env", {}).get("LT_FUSED_VAE") == "1"


def step_ops(cfg: dict) -> List[Op]:
    """Every matrix operation of one frame of the served step."""
    u, v = cfg["unet"], cfg["vae"]
    uq, vq = _int8(cfg, "unet_int8"), _int8(cfg, "vae_int8")
    aq = uq and bool(cfg["program"].get("attn_int8", 1))
    vmid = vq and bool(cfg["program"].get("vae_mid_int8", 1))
    fused = _fused_vae(cfg)
    ops: List[Op] = []
    S = cfg["serving"]["audio_rows"]
    cross = u["cross_attention_dim"]
    bf = "bfloat16"

    def conv(name, h, w, cin, cout, k=3, quant=False, kernel="", residual=False, in_hw=None):
        fl = 2.0 * h * w * k * k * cin * cout
        op = Op(name, "int8" if quant else bf, fl)
        if kernel:
            ih, iw = in_hw or (h, w)
            in_b = ih * iw * cin * (2 if kernel == "conv5" else 1)
            op.group = kernel
            op.bytes_frame = in_b + h * w * cout * 2 * (2 if residual else 1)
            op.bytes_call = k * k * cin * cout + 8 * cout
            if kernel == "conv5":
                op.extra_f32 = 8.0 * ih * iw * cin
        ops.append(op)

    def lin(name, rows, i, o, quant=False):
        ops.append(Op(name, "int8" if quant else bf, 2.0 * rows * i * o))

    def k4(quant):  # the 3x3 stride-1 int8 kernel
        return "conv4" if quant else ""

    def resnet(p, h, w, cin, cout, tdim, quant, short_quant=True, vae=False, fused5=False):
        c1 = "conv5" if fused5 else k4(quant)
        conv(p + ".conv1", h, w, cin, cout, quant=quant, kernel=c1)
        if tdim:
            lin(p + ".time_emb_proj", 1, tdim, cout)
        conv(p + ".conv2", h, w, cout, cout, quant=quant, kernel=c1, residual=vae and quant)
        if cin != cout:
            conv(p + ".conv_shortcut", h, w, cin, cout, k=1, quant=quant and short_quant)

    def transformer(p, h, w, c):
        T = h * w
        heads = u["attention_head_dim"]
        lin(p + ".proj_in", T, c, c, aq)
        for n in ("to_q", "to_k"):
            lin(f"{p}.attn1.{n}", T, c, c)
        lin(p + ".attn1.to_v", T, c, c, aq)
        ops.append(Op(p + ".attn1", bf, 4.0 * T * T * c, "attention", 4.0 * T * c * 2))
        lin(p + ".attn1.to_out", T, c, c, aq)
        lin(p + ".attn2.to_q", T, c, c)
        lin(p + ".attn2.to_k", S, cross, c)
        lin(p + ".attn2.to_v", S, cross, c)
        ops.append(Op(p + ".attn2", bf, 4.0 * T * S * c))
        lin(p + ".attn2.to_out", T, c, c, aq)
        lin(p + ".ff.proj", T, c, 8 * c, aq)
        lin(p + ".ff.out", T, 4 * c, c, aq)
        lin(p + ".proj_out", T, c, c, aq)
        assert c % heads == 0

    # U-Net at the latent size
    ch, L = list(u["block_out_channels"]), u["layers_per_block"]
    tdim = 4 * ch[0]
    h = w = cfg["serving"]["latent_px"]
    conv("conv_in", h, w, u["in_channels"], ch[0], quant=uq, kernel=k4(uq))
    lin("time_embedding.linear_1", 1, ch[0], tdim)
    lin("time_embedding.linear_2", 1, tdim, tdim)
    skips, cin = [ch[0]], ch[0]
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(L):
            resnet(f"down_blocks.{i}.resnets.{j}", h, w, cin if j == 0 else ch[i], ch[i], tdim, uq)
            if kind.startswith("CrossAttn"):
                transformer(f"down_blocks.{i}.attentions.{j}", h, w, ch[i])
            skips.append(ch[i])
        if i < len(ch) - 1:
            conv(f"down_blocks.{i}.downsamplers.0.conv", h // 2, w // 2, ch[i], ch[i], quant=uq)
            h, w = h // 2, w // 2
            skips.append(ch[i])
        cin = ch[i]
    resnet("mid_block.resnets.0", h, w, ch[-1], ch[-1], tdim, uq)
    transformer("mid_block.attentions.0", h, w, ch[-1])
    resnet("mid_block.resnets.1", h, w, ch[-1], ch[-1], tdim, uq)
    rev, prev = ch[::-1], ch[-1]
    for i, kind in enumerate(u["up_block_types"]):
        for j in range(L + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", h, w, prev + skips.pop(), rev[i], tdim, uq)
            prev = rev[i]
            if kind.startswith("CrossAttn"):
                transformer(f"up_blocks.{i}.attentions.{j}", h, w, rev[i])
        if i < len(rev) - 1:
            h, w = 2 * h, 2 * w
            conv(f"up_blocks.{i}.upsamplers.0.conv", h, w, rev[i], rev[i], quant=uq, kernel=k4(uq))
    conv("conv_out", h, w, ch[0], u["out_channels"], quant=uq, kernel=k4(uq))

    # VAE decode from the latent to the face
    vch, lat = list(v["block_out_channels"]), v["latent_channels"]
    h = w = cfg["serving"]["latent_px"]
    conv("post_quant_conv", h, w, lat, lat, k=1)
    conv("decoder.conv_in", h, w, lat, vch[-1])
    for r in (0, 1):
        resnet(f"decoder.mid_block.resnets.{r}", h, w, vch[-1], vch[-1], 0, vmid, vae=True)
        if r == 0:
            T, c = h * w, vch[-1]
            for n in ("query", "key", "value", "proj_attn"):
                lin("decoder.mid_block.attentions.0." + n, T, c, c)
            ops.append(Op("decoder.mid_block.attentions.0", bf, 4.0 * T * T * c, "attention",
                          4.0 * T * c * 2))
    vrev, cin = vch[::-1], vch[-1]
    for i, c in enumerate(vrev):
        for j in range(v["layers_per_block"] + 1):
            # the fused chain starts at block 0's upsampler
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", h, w, cin if j == 0 else c, c, 0, vq,
                   short_quant=False, vae=True, fused5=fused and i > 0)
            cin = c
        if i < len(vrev) - 1:
            conv(f"decoder.up_blocks.{i}.upsamplers.0.conv", 2 * h, 2 * w, c, c, quant=vq,
                 kernel=("conv5" if fused else k4(vq)), in_hw=(h, w) if fused else None)
            h, w = 2 * h, 2 * w
    conv("decoder.conv_out", h, w, vch[0], v["out_channels"])
    return ops


def whisper_ops(cfg: dict) -> List[Op]:
    """The matrix operations of one feature request: the encoder over the
    30 s window (1500 positions), float32."""
    wc = cfg["whisper"]
    D, F_, T = wc["d_model"], wc["encoder_ffn_dim"], wc["max_source_positions"]
    f32 = "float32"
    ops = [Op("encoder.conv1", f32, 2.0 * 2 * T * wc["num_mel_bins"] * D * 3),
           Op("encoder.conv2", f32, 2.0 * T * D * D * 3)]
    for i in range(wc["encoder_layers"]):
        p = f"encoder.layers.{i}"
        ops += [Op(p + ".qkvo", f32, 4 * 2.0 * T * D * D),
                Op(p + ".attention", f32, 4.0 * T * T * D),
                Op(p + ".fc", f32, 2 * 2.0 * T * D * F_)]
    return ops


def least_s(ops: List[Op], frames: float = 1.0) -> float:
    """Least time of ``ops`` over ``frames`` frames, each at its own peak."""
    return sum(op.least_s(frames) for op in ops)


def flops(ops: List[Op]) -> float:
    return sum(op.flops for op in ops)
