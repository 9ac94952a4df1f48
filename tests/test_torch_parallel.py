"""The port's multiple devices (``livetalking_tpu_torch/parallel/``) on the
CPU against the JAX package.

  - The mesh helpers and the sharding rule beside
    ``livetalking_tpu/parallel/mesh.py``'s (the rule on PyTorch's conv
    layouts: output channels on axis 0, axis 1 for a transposed conv).
  - One module-scoped group of four gloo ranks (dp=2 x tp=2) for the
    rest: the sharded MuseTalk step at tests/test_parallel.py's tiny
    config against the JAX package's single-device step (1 LSB, the bar
    test_parallel.py holds JAX's own sharded step to), Wav2Lip with
    tp-sharded parameters and a dp batch against JAX's single-device step,
    one coalesced scheduler round with the masked paste composed against
    the port's single-device step and paste (the sharded step itself is
    held to JAX above), MuseTalk's tiny L1 recipe under ``--mesh`` through
    kernel 3's plain version against one rank, and the batch errors.
  - ``train.cli.main`` with ``--mesh dp=2 --device cpu`` (its own two
    ranks) for Wav2Lip, against the one-process run at the same global
    batch: losses within 1e-6, each leaf's gradient (through its first Adam
    moment in ``.state``) within ``GRAD_REL`` relative L2 (why not 1e-5:
    there); the CLI itself checks the parameters bit-equal across ranks
    after each step.
  - ``--profile_dir``'s profiler writes a trace on the CPU.

Every spawn has its timeouts (``parallel/dist.py``): a hang fails here.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import musetalk as jmt
from livetalking_tpu.models import sd_unet as jsd_unet
from livetalking_tpu.models import wav2lip as jw2l
from livetalking_tpu.parallel import mesh as jmesh
from livetalking_tpu_torch import app
from livetalking_tpu_torch.models import sd_unet
from livetalking_tpu_torch.models import wav2lip as tw2l
from livetalking_tpu_torch.models.layers import torch_conv_to_hwio, torch_tconv_to_hwio
from livetalking_tpu_torch.parallel import dist as pdist
from livetalking_tpu_torch.parallel import dryrun
from livetalking_tpu_torch.parallel import mesh as tmesh
from livetalking_tpu_torch.train import cli
from livetalking_tpu_torch.utils.checkpoint import load_pytree
from test_torch_musetalk_train import tree_to_jax
from test_torch_train_cli_families import narrow_vae_dir
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

CFG = dict(block_out=(32, 64, 128, 128), heads=2)  # tests/test_parallel.py's
CFG_T = sd_unet.UNetConfig(**CFG)
SPEC = "dp=2,tp=2"
SEED = 1
# --mesh training's gradient leaves against one rank (relative L2). Not
# 1e-5: the recipes' L1 terms have sign gradients, and f32 rounding that
# depends on the batch (the tiny U-Net's output moves by 1.8e-6 between a
# B=1 and a B=2 forward) flips the sign wherever prediction and target
# are within it. Measured worst leaves: Wav2Lip 1.0e-2, MuseTalk 9.6e-3;
# one more torch thread alone moves the one-process Wav2Lip run's by
# 2.7e-3. The losses hold to 1e-6.
GRAD_REL = 5e-2


@pytest.mark.parametrize("spec", ["dp=4,tp=2", "dp=8", "tp=2,dp=1", "dp=2, tp=2,"])
def test_parse_mesh_spec_matches_jax(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


def test_mesh_errors_outside_a_group():
    with pytest.raises(ValueError, match="devices"):
        jmesh.make_mesh("dp=3,tp=5")
    with pytest.raises(ValueError, match="needs 15 devices, have 1"):
        tmesh.make_mesh("dp=3,tp=5", devices=["cpu"])
    with pytest.raises(ValueError, match="unknown axis"):
        tmesh.make_mesh("pp=1", devices=["cpu"])
    with pytest.raises(RuntimeError, match="only 1 rank"):
        tmesh.default_mesh_for(4)
    one = tmesh.make_mesh("", devices=["cpu"])  # one rank: every collective is the identity
    x = torch.arange(6.0).reshape(3, 2)
    assert one.shape == {"dp": 1, "tp": 1} and tmesh.gather_batch(x, one) is not None
    assert torch.equal(tmesh.shard_batch(x, one), x)


def test_more_ranks_than_cards_raise(monkeypatch):
    """One card per rank under NCCL: more ranks than cards raise, and so
    do two NCCL ranks on one card (only gloo may share a card)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="2 ranks need 2 CUDA devices, this host has 1"):
        pdist.rank_devices(2, "cuda")
    with pytest.raises(ValueError, match="only with backend='gloo'"):
        pdist.rank_devices(2, backend="nccl", devices=["cuda:0", "cuda:0"])
    devices, backend = pdist.rank_devices(2, backend="gloo", devices=["cuda:0", "cuda:0"])
    assert backend == "gloo" and devices == [torch.device("cuda", 0)] * 2
    assert pdist.rank_devices(2, "cpu") == ([torch.device("cpu")] * 2, "gloo")


# (HWIO shape as the JAX package keeps it, transposed conv?)
RULE_SHAPES = [((3, 3, 64, 256), False), ((3, 3, 3, 16), False), ((1, 1, 512, 128), False),
               ((3, 3, 128, 130), False), ((4, 4, 1024, 512), True), ((3, 3, 160, 64), True),
               ((7, 7, 6, 16), False)]


@pytest.mark.parametrize("hwio,transpose", RULE_SHAPES)
def test_param_rule_decides_like_jax(hwio, transpose):
    """The port's rule shards the same convs as ``_param_spec`` on the same
    shapes: JAX's kernels are HWIO (output channels last), the port's
    (O, I, kh, kw), a transposed conv's (I, O, kh, kw)."""
    from jax.sharding import PartitionSpec as P

    h, w, i, o = hwio
    torch_shape = (i, o, h, w) if transpose else (o, i, h, w)
    sharded = jmesh._param_spec(hwio, 2) != P()
    axis = tmesh.param_spec(torch_shape, 2, transpose)
    assert (axis is not None) == sharded
    if sharded:
        assert torch_shape[axis] == hwio[-1]
    assert tmesh.param_spec(torch_shape, 1, transpose) is None


def wav2lip_to_jax(model) -> dict:
    """The port's Wav2Lip module as the JAX package's tree (HWIO; a
    transposed conv's weight flipped), the inverse of ``params_from_jax``."""
    tree = {}
    for layer, path in model.layers():
        w = layer.conv.weight.detach().numpy()
        to_hwio = torch_tconv_to_hwio if layer.spec.transpose else torch_conv_to_hwio
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = {"w": np.ascontiguousarray(to_hwio(w)),
                          "b": layer.conv.bias.detach().numpy()}

    def lists(n):  # integer-keyed levels become lists
        if isinstance(n, dict) and "w" not in n:
            items = {k: lists(v) for k, v in n.items()}
            return [items[i] for i in sorted(items)] if 0 in items else items
        return n
    return lists(tree)


@pytest.fixture(scope="module")
def ranks():
    with pdist.Ranks(4, device="cpu", threads=1, timeout_s=60) as r:
        yield r


@pytest.fixture(scope="module")
def musetalk_case():
    """The port's seeded tiny U-Net and full VAE (the ranks make the same
    from ``SEED``) in the JAX package's layout, and its single-device
    step's frames on test_parallel.py's inputs."""
    unet, vae = (tree_to_jax(t) for t in dryrun.musetalk_weights(SEED, CFG_T, "cpu", "float32"))
    rng = np.random.default_rng(0)
    B = 4
    cycle = rng.standard_normal((4, 16, 16, 8)).astype(np.float32)  # 128 px decode
    idxs = np.arange(B, dtype=np.int32) % 4
    whisper = rng.standard_normal((B, 50, 384)).astype(np.float32)
    ref = np.asarray(jmt.make_infer_fn(jsd_unet.UNetConfig(**CFG), B, dtype=jnp.float32)(
        unet, vae, cycle, idxs, whisper))
    assert 0.1 < float(((ref > 0) & (ref < 255)).mean())  # not a saturated image
    return {"inputs": (cycle, idxs, whisper), "ref": ref}


def test_default_mesh_shapes_match_jax(ranks):
    shapes = ranks.run(dryrun.mesh_shape, 4)
    want = dict(jmesh.default_mesh_for(4).shape)
    assert all(s == want for s in shapes) and want == {"dp": 2, "tp": 2}


def test_sharded_musetalk_step_matches_jax_single_device(ranks, musetalk_case):
    """dp x tp MuseTalk step (``make_sharded_infer_fn``) within 1 LSB of the
    JAX package's single-device ``make_infer_fn``; every rank runs self-
    attention through kernel 3's wrapper (its plain version here)."""
    rs = ranks.run(dryrun.musetalk_frames, SEED, CFG_T, *musetalk_case["inputs"], spec=SPEC)
    got = rs[0]["frames"]
    assert got.shape == (4, 128, 128, 3) and got.dtype == np.uint8
    assert dryrun.lsb(got, musetalk_case["ref"]) <= 1


def test_sharded_wav2lip_matches_jax_single_device(ranks):
    """Wav2Lip with tp-sharded parameters (``shard_params``: every conv
    with >= 128 output channels) and a dp batch through the unchanged
    ``make_infer_fn``: within 1 LSB of JAX's single-device step
    (test_parallel.py's setup)."""
    params = wav2lip_to_jax(tw2l.init_model(3))  # the ranks make the same from seed 3
    rng = np.random.default_rng(3)
    B, S = 4, 256
    cycle = rng.integers(0, 255, (4, S, S, 3)).astype(np.uint8)
    idxs = np.arange(B, dtype=np.int32) % 4
    mel = rng.standard_normal((B, 80, 16)).astype(np.float32)
    ref = np.asarray(jw2l.make_infer_fn(B, S, dtype=jnp.float32)(params, cycle, idxs, mel))
    got = ranks.run(dryrun.wav2lip_frames, 3, cycle, idxs, mel, spec=SPEC)[0]["frames"]
    assert dryrun.lsb(got, ref) <= 1


def test_coalesced_scheduler_round_with_paste(ranks, musetalk_case):
    """Two sessions coalesced into one super-batch by the scheduler on rank
    0, the other ranks following; the masked paste composed on rank 0:
    the frames of the single-device step and paste."""
    rs = ranks.run(dryrun.scheduler_round, SEED, CFG_T, spec=SPEC)
    assert rs[0]["batches"] == 1 and [r["served"] for r in rs[1:]] == [1, 1, 1]
    assert rs[0]["frames"].shape == (2, 160, 160, 3)
    assert dryrun.lsb(rs[0]["frames"], rs[0]["single"]) <= 1


def test_musetalk_mesh_training_matches_one_rank(ranks, tmp_path):
    """A ``--mesh dp=2,tp=2`` MuseTalk L1 step (tiny U-Net, a narrow VAE from
    ``--models_dir``, kernel 3's plain version): each tp pair computes the
    same dp slice; losses and every leaf's all-reduced gradient against
    one rank's run at the same global batch (a leaf that cancels to
    rounding noise, below 1e-6 of the largest, within 1e-6 of the
    largest's norm, tests/test_torch_musetalk_train.py's floor),
    parameters bit-equal across the four ranks after the step (the CLI
    raises otherwise)."""
    argv = ["--family", "musetalk", "--size", "tiny", "--recipe", "l1", "--synthetic", "8",
            "--steps", "1", "--batch_size", "2", "--mesh", SPEC, "--device", "cpu",
            "--models_dir", narrow_vae_dir(tmp_path)]
    rs = ranks.run(dryrun.train_parity, argv)
    r = rs[0]
    assert r["loss_rel"] <= 1e-6 and r["grad_rel"] <= GRAD_REL and r["leaves"] > 50
    assert r["cancelled_err"] <= dryrun.CANCELLED


def test_batch_errors(ranks):
    cfg = sd_unet.UNetConfig(**CFG)
    rng = np.random.default_rng(1)
    with pytest.raises(RuntimeError, match="batch 3 not divisible by dp=2"):
        ranks.run(dryrun.musetalk_frames, 0, cfg, rng.standard_normal((4, 16, 16, 8)),
                  np.arange(3, dtype=np.int32), rng.standard_normal((3, 50, 384)), spec=SPEC)
    base = ["--synthetic", "8", "--size", "tiny", "--device", "cpu", "--steps", "1"]
    with pytest.raises(SystemExit, match="2 clip"):  # 10 frames: 2 clips over dp=4
        cli.main(["--family", "wav2lip", "--recipe", "full", "--batch_size", "10",
                  "--mesh", "dp=4"] + base)
    with pytest.raises(SystemExit, match="3 clip"):
        cli.main(["--family", "wav2lip", "--batch_size", "3", "--mesh", "dp=2"] + base)


def _moments(state_path):
    """The first Adam moment of every leaf in a ``.state`` file."""
    st = load_pytree(state_path)["opts"]["opt_state"]["opt"]["state"]
    return [np.asarray(st[k]["exp_avg"]) for k in sorted(st)]


def test_wav2lip_cli_mesh_matches_one_process(tmp_path):
    """``main(["--mesh", "dp=2", "--device", "cpu", ...])`` spawns two gloo
    ranks; one step of Wav2Lip's L1 recipe at global batch 2 against the
    one-process run: the loss within 1e-6, each leaf's gradient (its first
    Adam moment, 0.1 g) within ``GRAD_REL``; only rank 0 writes ``--out``."""
    args = ["--family", "wav2lip", "--synthetic", "8", "--steps", "1", "--batch_size", "2",
            "--device", "cpu", "--log_every", "1"]
    seen = []
    mesh = cli.main(args + ["--mesh", "dp=2", "--out", str(tmp_path / "m.pkl")],
                    on_step=lambda i, m: seen.append(m))
    one = cli.main(args + ["--out", str(tmp_path / "o.pkl")])
    assert seen == [mesh] and mesh.keys() == one.keys()
    assert mesh["loss"] == pytest.approx(one["loss"], rel=1e-6)
    got, want = _moments(tmp_path / "m.pkl.state"), _moments(tmp_path / "o.pkl.state")
    assert len(got) == len(want) > 50
    assert max(float(np.linalg.norm(g - w) / np.linalg.norm(w))
               for g, w in zip(got, want)) <= GRAD_REL
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.pkl", "m.pkl.state", "o.pkl",
                                                           "o.pkl.state"]
    for p in tmp_path.iterdir():  # 1.2 GB of weights and Adam moments
        p.unlink()


def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path):
    stop = app.start_profiler(str(tmp_path / "prof"), "cpu")
    x = torch.randn(2, 8, 16, 16)
    torch.nn.functional.conv2d(x, torch.randn(4, 8, 3, 3))
    path = stop()
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::conv2d" in names
