"""The port's training CLI (``python -m livetalking_tpu_torch.train``) on
the CPU: tiny synthetic Ultralight runs of both recipes (the other
families: test_torch_train_cli_families.py), ``--resume``
continuing a run bit for bit (2 + 2 steps give the 4-step run's weights
and metrics), ``--init`` and ``--sync_init`` reading trees in the JAX
package's layout (written here with numpy from its inits, without its
CLI) and in the port's own, ``--mesh`` and ``--device cuda`` without a
card raising (``--mesh`` itself: tests/test_torch_parallel.py).
"""

import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import syncnet as jsn
from livetalking_tpu.models import ultralight as jul
from livetalking_tpu_torch.models import syncnet as tsn
from livetalking_tpu_torch.models import ultralight as tul
from livetalking_tpu_torch.models import wav2lip as tw2l
from livetalking_tpu_torch.train import cli
from livetalking_tpu_torch.utils.checkpoint import (
    PORT_FORMAT,
    load_params,
    load_pytree,
    save_params,
)
from livetalking_tpu_torch.utils.tree import tree_leaves
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["--synthetic", "8", "--size", "tiny", "--device", "cpu", "--log_every", "1"]


def check_family_run(tmp_path, family, recipe, batch, extra=()):
    out = str(tmp_path / "w.pkl")
    m = cli.main(["--family", family, "--recipe", recipe, "--steps", "1", "--batch_size",
                  str(batch), "--out", out] + BASE + list(extra))
    assert m and all(np.isfinite(v) for v in m.values())
    tree, port = load_params(out)
    assert port and load_pytree(out)["format"] == PORT_FORMAT
    assert load_pytree(out + ".state")["step"] == 1
    if family == "wav2lip":  # the module's state dict loads back into the module
        tw2l.Wav2Lip().load_state_dict({k: torch.from_numpy(v) for k, v in tree.items()})


def np_pickle(path, tree):
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, tree), f)


@pytest.mark.parametrize("recipe,batch", [("l1", 2), ("full", 5)])
def test_ultralight_trains_and_saves(tmp_path, recipe, batch):
    check_family_run(tmp_path, "ultralight", recipe, batch)


def test_resume_continues_bit_for_bit(tmp_path):
    args = ["--family", "ultralight", "--batch_size", "2", "--lr", "1e-3"] + BASE
    whole = str(tmp_path / "whole.pkl")
    half = str(tmp_path / "half.pkl")
    resumed = str(tmp_path / "resumed.pkl")
    seen = {}
    m4 = cli.main(args + ["--steps", "4", "--out", whole],
                  on_step=lambda i, m: seen.setdefault("whole", []).append(m))
    cli.main(args + ["--steps", "2", "--out", half])
    m2 = cli.main(args + ["--steps", "4", "--resume", half + ".state", "--out", resumed],
                  on_step=lambda i, m: seen.setdefault("resumed", []).append(m))
    assert m2 == m4 and seen["resumed"] == seen["whole"][2:]
    a, b = tree_leaves(load_params(whole)[0]), tree_leaves(load_params(resumed)[0])
    assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_init_from_a_jax_layout_tree(tmp_path):
    """A JAX-layout weights tree goes through ``params_from_jax``: with a
    zero learning rate the saved weights are exactly that conversion."""
    jpath = str(tmp_path / "jax_ul.pkl")
    jp = jax.jit(lambda k: jul.init_params(k, jnp.float32))(jax.random.PRNGKey(3))
    np_pickle(jpath, jp)
    out = str(tmp_path / "ul.pkl")
    cli.main(["--family", "ultralight", "--steps", "1", "--batch_size", "1", "--lr", "0",
              "--init", jpath, "--out", out] + BASE)
    want = [t.numpy() for t in tree_leaves(tul.params_from_jax(jax.tree.map(np.asarray, jp)))]
    got = tree_leaves(load_params(out)[0])
    assert len(got) == len(want) and all(np.array_equal(a, b) for a, b in zip(got, want))
    # and the port's own layout, written by the run, reads back the same
    out2 = str(tmp_path / "ul2.pkl")
    cli.main(["--family", "ultralight", "--steps", "1", "--batch_size", "1", "--lr", "0",
              "--init", out, "--out", out2] + BASE)
    assert all(np.array_equal(a, b) for a, b in zip(tree_leaves(load_params(out2)[0]), got))



def test_sync_init_enables_the_sync_term(tmp_path):
    spath, ppath = str(tmp_path / "jax_sync.pkl"), str(tmp_path / "port_sync.pkl")
    jtree = jax.tree.map(np.asarray,
                         jax.jit(lambda k: jsn.init_params(k, 160))(jax.random.PRNGKey(5)))
    np_pickle(spath, jtree)
    save_params(ppath, tsn.params_from_jax(jtree))  # the same expert in the port's layout
    args = ["--family", "ultralight", "--recipe", "full", "--steps", "1", "--batch_size",
            "5"] + BASE
    off = cli.main(args)
    on = cli.main(args + ["--sync_init", spath])
    assert off["loss"] == off["l1"]  # weight 0 without a trained expert
    assert on["loss"] == pytest.approx(0.7 * on["l1"] + 0.3 * on["sync"], rel=1e-6)
    assert cli.main(args + ["--sync_init", ppath]) == on


def test_mesh_and_cuda_without_a_card_raise():
    """``--mesh`` asks for one card per rank, as ``--device cuda`` asks for
    one: without a card both raise before any work (nothing falls back to
    the CPU; ``--device cpu`` asks for gloo ranks)."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    args = ["--family", "ultralight", "--synthetic", "8", "--size", "tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args + ["--mesh", "dp=2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(args)


def test_module_entry_point_parses_its_flags():
    r = subprocess.run([sys.executable, "-m", "livetalking_tpu_torch.train", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "--device" in r.stdout and "--sync_backend" in r.stdout
