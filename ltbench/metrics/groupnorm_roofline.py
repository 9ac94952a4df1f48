"""groupnorm_roofline: least time of the traced steps' GroupNorm sites on the bf16
route (every GroupNorm of the U-Net and the VAE decode, 91 a frame at MuseTalk
v1.5's widths: x read once and y written once in bfloat16, 4 bytes an element, at
3.35 TB/s) over the device time of kernel 6's kernels in those steps, the complete
steps of the trace as ``ltbench.stats.kernel_share`` takes them. Kernels by name
from csrc/norm.cu: group_norm_moments_kernel, group_norm_apply_kernel. Sites are
counted from the configuration's shapes here; on the int8 route (kernel 5 holds
most GroupNorms) it reads nothing."""

import re
from typing import List, Tuple

from ltbench.stats import STEP_MARKER, frames_per_step
from ltbench.work import PEAKS

NAMES = re.compile(r"group_norm_(moments|apply)_kernel")
BYTES_PER_ELEMENT = 4  # bfloat16 x read once, y written once


def sites(cfg: dict) -> List[Tuple[str, int]]:
    """(site, elements a frame) of every GroupNorm of the served step."""
    u, v = cfg["unet"], cfg["vae"]
    out: List[Tuple[str, int]] = []

    def norm(name, px, c):
        out.append((name, px * px * c))

    def resnet(p, px, cin, cout):
        norm(p + ".norm1", px, cin)
        norm(p + ".norm2", px, cout)

    ch, L = list(u["block_out_channels"]), u["layers_per_block"]
    px = cfg["serving"]["latent_px"]
    skips, cin = [ch[0]], ch[0]
    for i, kind in enumerate(u["down_block_types"]):
        for j in range(L):
            resnet(f"down_blocks.{i}.resnets.{j}", px, cin if j == 0 else ch[i], ch[i])
            if kind.startswith("CrossAttn"):
                norm(f"down_blocks.{i}.attentions.{j}.norm", px, ch[i])
            skips.append(ch[i])
        if i < len(ch) - 1:
            px //= 2
            skips.append(ch[i])
        cin = ch[i]
    resnet("mid_block.resnets.0", px, ch[-1], ch[-1])
    norm("mid_block.attentions.0.norm", px, ch[-1])
    resnet("mid_block.resnets.1", px, ch[-1], ch[-1])
    rev, prev = ch[::-1], ch[-1]
    for i, kind in enumerate(u["up_block_types"]):
        for j in range(L + 1):
            resnet(f"up_blocks.{i}.resnets.{j}", px, prev + skips.pop(), rev[i])
            prev = rev[i]
            if kind.startswith("CrossAttn"):
                norm(f"up_blocks.{i}.attentions.{j}.norm", px, rev[i])
        if i < len(rev) - 1:
            px *= 2
    norm("conv_norm_out", px, ch[0])

    vch = list(v["block_out_channels"])
    px = cfg["serving"]["latent_px"]
    resnet("decoder.mid_block.resnets.0", px, vch[-1], vch[-1])
    norm("decoder.mid_block.attentions.0.group_norm", px, vch[-1])
    resnet("decoder.mid_block.resnets.1", px, vch[-1], vch[-1])
    vrev, cin = vch[::-1], vch[-1]
    for i, c in enumerate(vrev):
        for j in range(v["layers_per_block"] + 1):
            resnet(f"decoder.up_blocks.{i}.resnets.{j}", px, cin, c)
            cin = c
        if i < len(vrev) - 1:
            px *= 2
    norm("decoder.conv_norm_out", px, vch[0])
    return out


def read(run):
    program = run.cfg["program"]
    if program.get("vae_int8") or program.get("unet_int8"):
        return None
    tr = run.trace
    if tr is None:
        return None
    marks = [t for n, _s, t in tr.kernels if STEP_MARKER.search(n)]
    per_step = frames_per_step(run)
    if len(marks) < 2 or not per_step:
        return None
    lo, hi = marks[0], marks[-1]
    busy = sum(t - s for n, s, t in tr.kernels if lo <= s and t <= hi and NAMES.search(n))
    if busy <= 0:
        return None
    elements = sum(n for _name, n in sites(run.cfg))
    least = ((len(marks) - 1) * per_step * elements * BYTES_PER_ELEMENT
             / PEAKS["hbm_bytes_per_s"])
    return 100.0 * least / (busy / 1e9)
