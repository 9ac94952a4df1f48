"""Time the paste-back kernels of one checkout with chip_smoke.py's phases.

    python tools/paste_ab.py [--root DIR]

Runs ``phase_blend`` and ``phase_blend_mask`` of this repository's
``chip_smoke.py`` on one CUDA card, with the ``livetalking_tpu_torch``
package imported from DIR (default: this repository). DIR may hold an
earlier commit unpacked with ``git archive`` into a directory that
``.gitignore`` lists (``scratch_tree/``): run this once per checkout, each
in its own process, in turns within one call (earlier, this, this,
earlier), to compare two kernels on one card. An earlier package whose
``make_resize_paste_fn`` and ``make_masked_paste_fn`` gather the frames
first is timed on that route. Prints the card's name and power limit, then
the phases' lines; exits 1 without a CUDA device.
"""

import argparse
import importlib.util
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO,
                    help="directory holding the livetalking_tpu_torch package to time")
    root = os.path.abspath(ap.parse_args(argv).root)
    import torch

    if not torch.cuda.is_available():
        print("paste_ab: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    c = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(c)
    from livetalking_tpu_torch.ops import _build, blend
    from livetalking_tpu_torch.utils import synthetic

    if not blend.__file__.startswith(root):
        raise AssertionError(f"imported {blend.__file__}, not from {root}")
    print(c.smi("name,power.limit"), flush=True)
    name = torch.cuda.get_device_name(0)
    peak_bw, peak_f32, _ = [p[1:] for p in c.PEAKS if p[0] in name][0]
    clock_hz = float(c.smi("clocks.max.sm").split()[0]) * 1e6
    _build.build_all()
    c.log("paste_ab", root=root, package=os.path.dirname(blend.__file__))
    c.phase_blend(torch, blend, peak_bw, peak_f32, clock_hz)
    c.phase_blend_mask(torch, blend, synthetic, peak_bw, peak_f32, clock_hz)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
