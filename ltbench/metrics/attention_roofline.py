"""attention_roofline: least time of the traced steps' self-attention calls (17 a
frame: bytes of q, k, v, o in bfloat16 at 3.35 TB/s against 4 T^2 C at 989 TFLOP/s,
the larger) over the device time of kernel 3's kernels in those steps. Kernels by
name from csrc/attention.cu: attention_kernel, attention_tc_kernel,
attention_wide_kernel."""

import re

from ltbench.stats import kernel_share

NAMES = re.compile(r"attention_(tc_|wide_)?kernel")


def read(run):
    return kernel_share(run, NAMES, ("attention",))
