"""int8_conv_roofline: least time of the traced steps' 3x3 int8 conv sites (kernel
4: max(bytes at 3.35 TB/s, 2 M 9C O at 1,979 TOP/s); kernel 5 adds 8 float32
operations per input element at 67 TFLOP/s) over the device time of their kernels.
Kernels by name from csrc/conv.cu: conv3x3_kernel, conv3x3_gnq_kernel."""

import re

from ltbench.stats import kernel_share

NAMES = re.compile(r"conv3x3_(gnq_)?kernel")


def read(run):
    return kernel_share(run, NAMES, ("conv4", "conv5"))
