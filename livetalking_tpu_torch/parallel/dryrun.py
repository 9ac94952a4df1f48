"""The multi-device dry run (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``):

    python -m livetalking_tpu_torch.parallel.dryrun N [--device cpu]

spawns N ranks (one per card, or gloo ranks on the CPU) over
``default_mesh_for(N)`` and runs, each checked:

  1. one Wav2Lip training step with tp-sharded parameters and a dp batch
     (one 256 px sample per dp rank): a finite loss, shards equal across dp;
  2. Wav2Lip's inference step over the mesh against the single-device
     step: at most 1 LSB apart;
  3. the dp x tp MuseTalk step (``make_sharded_infer_fn``; the tiny U-Net
     (32, 64, 128, 128), heads 2, the full VAE, 128 px decode) against the
     single-device step: at most 1 LSB;
  4. one coalesced ``BatchScheduler`` round over that step on rank 0, the
     other ranks following (``engine/scheduler.py::SpmdLeader``), with the
     masked paste composed: the frames of the single-device step and paste.

The functions below run on every rank (``parallel.dist.Ranks.run``); the
tests and ``chip_smoke.py`` call them too. ``weights`` is a seed (the
port's random init) or the path of a pickled tree in the JAX package's
layout (``utils/checkpoint.py::save_pytree``).
"""

from __future__ import annotations

import argparse
import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

from livetalking_tpu_torch.parallel import dist as pdist
from livetalking_tpu_torch.parallel.mesh import (
    DP_AXIS,
    default_mesh_for,
    gather_batch,
    make_mesh,
    shard_batch,
    shard_params,
)

DRY_UNET = dict(block_out=(32, 64, 128, 128), heads=2)
# relative to the largest leaf's norm: a gradient leaf this small is
# rounding noise, held to this much of the largest in absolute L2
CANCELLED = 1e-6


def _mesh(spec: str):
    return make_mesh(spec) if spec else default_mesh_for(pdist.current().world_size)


def mesh_shape(n: int) -> Dict[str, int]:
    """``default_mesh_for(n).shape`` on this rank."""
    return dict(default_mesh_for(n).shape)


def _tensor(a, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def lsb(a: np.ndarray, b: np.ndarray) -> int:
    """Largest uint8 difference of two frame batches."""
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).max())


def _wav2lip(weights, dev, dtype=torch.float32):
    from livetalking_tpu_torch.models import wav2lip as w2l
    from livetalking_tpu_torch.utils.checkpoint import load_pytree

    model = (w2l.params_from_jax(load_pytree(weights)) if isinstance(weights, str)
             else w2l.init_model(weights))
    return w2l.prepare(model, dev, dtype)


def musetalk_weights(weights, cfg, dev, dtype: str):
    """(U-Net, VAE) trees: the port's inits from seeds ``weights`` and
    ``weights + 1``, or a pickled ``{"unet", "vae"}`` in the JAX layout."""
    return _musetalk(weights, cfg, torch.device(dev), getattr(torch, dtype))


@functools.lru_cache(maxsize=1)  # the last model stays: the checks run several meshes
def _musetalk(weights, cfg, dev, dtype):
    from livetalking_tpu_torch.models import sd_unet, sd_vae
    from livetalking_tpu_torch.utils.checkpoint import load_pytree

    if isinstance(weights, str):
        tree = load_pytree(weights)
        return (sd_unet.params_from_jax(tree["unet"], dtype, dev),
                sd_vae.params_from_jax(tree["vae"], dtype, dev))
    return (sd_unet.init_params(weights, cfg, dtype, dev),
            sd_vae.init_params(weights + 1, dtype, dev))


def wav2lip_frames(weights, cycle: np.ndarray, idxs: np.ndarray, mel: np.ndarray,
                   spec: str = "", single: bool = False) -> Optional[Dict[str, np.ndarray]]:
    """Wav2Lip's unchanged ``make_infer_fn`` over the mesh: the module from
    ``shard_params`` (tp), the batch from ``shard_batch`` (dp), the frames
    gathered. On rank 0 ``{"frames"}`` (and with ``single`` the
    single-device step's ``"single"``), None elsewhere."""
    from livetalking_tpu_torch.models import wav2lip as w2l

    mesh = _mesh(spec)
    dev = mesh.device
    model = _wav2lip(weights, dev)
    B, S = idxs.shape[0], cycle.shape[1]
    infer = w2l.make_infer_fn(B // mesh.shape[DP_AXIS], S, dtype=torch.float32)
    cyc, ids, m = _tensor(cycle, dev), _tensor(idxs, dev), _tensor(mel, dev)
    out = gather_batch(infer(shard_params(model, mesh), cyc, shard_batch(ids, mesh),
                             shard_batch(m, mesh)), mesh)
    if mesh.rank:
        return None
    res = {"frames": out.cpu().numpy()}
    if single:
        single_step = w2l.make_infer_fn(B, S, dtype=torch.float32)
        res["single"] = single_step(model, cyc, ids, m).cpu().numpy()
    return res


def musetalk_frames(weights, cfg, cycle: np.ndarray, idxs: np.ndarray, whisper: np.ndarray,
                    spec: str = "", dtype: str = "float32", single: bool = False,
                    timed: int = 0) -> Optional[Dict[str, Any]]:
    """``make_sharded_infer_fn`` over the mesh (parameters from
    ``shard_params``). On rank 0 ``{"frames", "attention_launches"}`` (and
    with ``single`` the single-device ``make_infer_fn``'s ``"single"``);
    elsewhere ``{"attention_launches"}``: kernel 3's launches in this
    rank's sharded step (0 on the CPU, which runs its plain version). In
    f32 the convolutions run without TF32.
    ``timed`` > 0 logs the checked call's collectives (the tp all-gathers'
    count, bytes and seconds, the dp gather's; each synchronized) and adds
    the step's median ms over that many more calls, per rank."""
    from livetalking_tpu_torch.models import musetalk as mt
    from livetalking_tpu_torch.ops.attention import attention

    mesh = _mesh(spec)
    dev = mesh.device
    dt = getattr(torch, dtype)
    if dt == torch.float32:  # f32 is f32: no TF32 convolutions
        torch.backends.cudnn.allow_tf32 = False
    unet, vae = _musetalk(weights, cfg, dev, dt)
    B = idxs.shape[0]
    cyc, ids, w = _tensor(cycle, dev), _tensor(idxs, dev), _tensor(whisper, dev)
    step = mt.make_sharded_infer_fn(cfg, B, mesh, dtype=dt)
    sharded = (shard_params(unet, mesh), shard_params(vae, mesh))
    before = attention.launches
    pdist.collective_log = [] if timed else None
    try:
        out = step(*sharded, cyc, ids, w)
        log = pdist.collective_log
    finally:
        pdist.collective_log = None
    res = {"attention_launches": attention.launches - before}
    if timed:
        res.update(_collectives(log, mesh.shape[DP_AXIS] > 1))
        res["step_ms"] = _median_ms(lambda: step(*sharded, cyc, ids, w), timed, dev)
    if mesh.rank:
        return res
    res["frames"] = out.cpu().numpy()
    if single:
        res["single"] = mt.make_infer_fn(cfg, B, dtype=dt)(unet, vae, cyc, ids, w).cpu().numpy()
    return res


def _collectives(log, dp_gather: bool) -> Dict[str, Any]:
    """A step's logged collectives: the tp all-gathers' count, bytes sent
    and seconds, and the dp gather of the faces (the step's last)."""
    tp, dpg = (log[:-1], log[-1:]) if dp_gather else (log, [])
    return {"tp_gathers": len(tp), "tp_gather_bytes": sum(b for _, b, _ in tp),
            "tp_gather_s": sum(t for *_, t in tp), "dp_gather_bytes": sum(b for _, b, _ in dpg),
            "dp_gather_s": sum(t for *_, t in dpg)}


def _median_ms(call, n: int, dev) -> float:
    import time

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    times = []
    for _ in range(n):
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def wav2lip_train_step(seed: int = 0, spec: str = "") -> Dict[str, float]:
    """One Wav2Lip L1 step with tp-sharded parameters and a dp batch of one
    256 px sample per dp rank; the gradients' mean over dp before Adam.
    Returns the dp-mean loss and the mesh's shape; raises unless each
    rank's shards equal those of the other dp ranks after the step."""
    from livetalking_tpu_torch.parallel.mesh import all_reduce_mean, check_replicas
    from livetalking_tpu_torch.train import wav2lip_train as wt

    mesh = _mesh(spec)
    dev = mesh.device
    model = shard_params(_wav2lip(seed, dev).train(), mesh)
    tx, raw = wt.make_train_step()
    opt = tx.init(model)
    opt.reduce_grads = functools.partial(all_reduce_mean, mesh)
    rng = np.random.default_rng(seed)
    B = mesh.shape[DP_AXIS]
    batch = {"mel": rng.standard_normal((B, 80, 16, 1)).astype(np.float32),
             "face": rng.random((B, 256, 256, 6)).astype(np.float32),
             "target": rng.random((B, 256, 256, 3)).astype(np.float32)}
    batch = {k: _tensor(v, dev) for k, v in shard_batch(batch, mesh).items()}
    loss = raw(model, opt, batch)[2].detach().reshape(1).double()
    loss = float(mesh.all_reduce_(loss, DP_AXIS)[0]) / B
    if not np.isfinite(loss):
        raise RuntimeError(f"dry run: non-finite loss {loss}")
    # each tp rank holds other shards; across dp each shard must be equal
    check_replicas(mesh, list(model.parameters()), 1, DP_AXIS)
    return {"loss": loss, "mesh": dict(mesh.shape)}


def round_avatars(rng, n_frames: int, S: int, Ho: int, Wo: int, H: int, W: int, item: tuple):
    """Two random latent cycles of ``item`` and the masked paste's planes
    for them (``AvatarStore`` aux): random H x W frames, one box of
    (Ho - 16) x (Wo - 16) at the same place in each."""
    cycles = [rng.standard_normal((n_frames,) + item).astype(np.float32) for _ in range(2)]
    masks = np.zeros((n_frames, Ho, Wo), np.uint8)
    masks[:, 8:Ho - 8, 8:Wo - 8] = 255
    aux = {"pb_frames": rng.integers(0, 255, (n_frames, H, W, 3)).astype(np.uint8),
           "pb_origins": np.tile(np.asarray([[10, 10]], np.int32), (n_frames, 1)),
           "pb_scalars": np.tile(np.asarray([[Ho - 16, Wo - 16, 8, 8]], np.int32),
                                 (n_frames, 1)),
           "pb_masks": masks}
    return cycles, aux


def scheduler_round(weights, cfg, spec: str = "", dtype: str = "float32", seed: int = 0,
                    B: Optional[int] = None, S: int = 128, frame: int = 160
                    ) -> Dict[str, Any]:
    """One coalesced round: two sessions of ``B`` frames (default dp / 2,
    at least 1) submit to a ``BatchScheduler`` on rank 0 whose step is the
    sharded MuseTalk step followed by the masked paste (``S`` px faces
    into ``frame`` x ``frame`` frames, rank 0 only), the other ranks
    following. Rank 0 returns ``{"frames", "single", "batches",
    "paste_launches"}``, ``single`` being the single-device step and paste
    of the same super-batch, ``paste_launches`` kernel 2's launches in the
    round (0 on the CPU); the others ``{"served"}``."""
    from livetalking_tpu_torch.ops.blend import blend_masked_
    from livetalking_tpu_torch.avatars import musetalk_avatar as plugin
    from livetalking_tpu_torch.engine.scheduler import (
        AvatarStore,
        BatchScheduler,
        SpmdLeader,
        serve_follower,
    )

    mesh = _mesh(spec)
    dev = mesh.device
    dt = getattr(torch, dtype)
    unet, vae = _musetalk(weights, cfg, dev, dt)
    params = (shard_params(unet, mesh), shard_params(vae, mesh))
    B = B or max(1, mesh.shape[DP_AXIS] // 2)
    Ho = Wo = S // 2
    H = W = frame
    item = (S // 8, S // 8, 8)
    if mesh.rank:
        factory = plugin.make_step_factory(cfg, dt, None, mesh=mesh)
        return {"served": serve_follower(mesh, params, factory, item, torch.float32)}

    rng = np.random.default_rng(seed)
    n_frames = 4
    cycles, aux = round_avatars(rng, n_frames, S, Ho, Wo, H, W, item)
    store = AvatarStore(item_shape=item, dtype=np.float32, device=dev)
    offs = [store.add(f"s{i}", c, aux=aux)[0] for i, c in enumerate(cycles)]
    spec_ = {"S": S, "H": H, "W": W, "Ho": Ho, "Wo": Wo}
    leader = SpmdLeader(mesh)
    sched = BatchScheduler(params, store,
                           leader.wrap(plugin.make_step_factory(cfg, dt, store, spec_, mesh=mesh)),
                           B, buckets=(2,))
    reqs = [((off + np.arange(B) % n_frames).astype(np.int32),
             rng.standard_normal((B, 50, 384)).astype(np.float32)) for off in offs]
    futs = [sched.submit(i, w) for i, w in reqs]  # queued before it starts: one batch
    before = blend_masked_.launches
    sched.start()
    try:
        frames = np.concatenate([f.result(timeout=600) for f in futs])
    finally:
        sched.stop()
        leader.stop()
    launches = blend_masked_.launches - before
    single_step = plugin.make_step_factory(cfg, dt, store, spec_)(2 * B)
    idxs = _tensor(np.concatenate([i for i, _ in reqs]), dev)
    whisper = _tensor(np.concatenate([w for _, w in reqs]), dev)
    single = single_step((unet, vae), store.buffer, idxs, whisper).cpu().numpy()
    return {"frames": frames, "single": single, "batches": sched.batches_run,
            "paste_launches": launches}


def _moments(opts) -> list:
    """Every trained leaf's first Adam moment, on the host. After N steps
    it is sum_i 0.1 * 0.9^(N-i) * g_i: equal moments mean equal gradients
    wherever the runs' parameters were equal, as through MuseTalk's first
    update (its schedule starts at 0)."""
    return [o.opt.state[p]["exp_avg"].detach().cpu() if p in o.opt.state else None
            for o in opts.values() for p in o.params]


def train_parity(argv) -> Dict[str, Any]:
    """The training CLI's run of ``argv`` (with ``--mesh``) on this rank,
    held, on rank 0, to the one-rank run of the same flags without
    ``--mesh`` (the same global batch): each step's metrics (relative
    error) and each leaf's all-reduced gradient through its first Adam
    moment (``grad_rel``: relative L2; ``cancelled_err``: a leaf below
    ``CANCELLED`` of the largest leaf's norm, its error over that norm).
    Parameters are checked bit-equal across ranks after each step
    (``--log_every 1``). TF32 is off and cuDNN's algorithms deterministic
    for both runs, so only the order of sums separates them. Returns, per
    rank, the peak device memory and the gradient all-reduces of the last
    step (bytes, seconds);
    rank 0 adds the errors and both runs' step times."""
    import gc
    import time

    from livetalking_tpu_torch.train import cli

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True  # same algorithms in both runs
    args = cli.parse_args(list(argv) + ["--log_every", "1"])
    mesh = make_mesh(args.mesh)
    cuda = mesh.device.type == "cuda"
    _musetalk.cache_clear()  # earlier checks' models and cached blocks: ranks may share a card
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    pdist.collective_log = []
    steps = []
    out = cli.train(args, mesh, on_step=lambda i, m: steps.append(
        (time.perf_counter(), list(pdist.collective_log))))
    pdist.collective_log = None
    res: Dict[str, Any] = {
        "peak_gb": torch.cuda.max_memory_allocated() / 1e9 if cuda else None,
        "all_reduce": [(b, t) for op, b, t in steps[-1][1] if op == "all_reduce"]
        if len(steps) < 2 else
        [(b, t) for op, b, t in steps[-1][1][len(steps[-2][1]):] if op == "all_reduce"],
        "step_s": steps[-1][0] - steps[-2][0] if len(steps) > 1 else None}
    if mesh.rank:
        del out
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        return res
    got = _moments(out["optimizers"])
    hist = out["history"]
    del out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref_args = cli.parse_args(list(argv) + ["--log_every", "1", "--mesh", "",
                                            "--device", str(mesh.device)])
    t = []
    ref = cli.train(ref_args, on_step=lambda i, m: t.append(time.perf_counter()))
    want = _moments(ref["optimizers"])
    res["ref_step_s"] = t[-1] - t[-2] if len(t) > 1 else None
    res["loss_rel"] = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12)
                          for (_, a), (_, b) in zip(hist, ref["history"], strict=True)
                          for k in b)
    pairs = [(float((g - w).norm()), float(w.norm()))
             for g, w in zip(got, want, strict=True) if w is not None]
    # a leaf whose gradient cancels to rounding noise (biases in front of a
    # GroupNorm) is held in absolute terms, as tests/test_torch_musetalk_train.py does
    floor = CANCELLED * max(n for _, n in pairs)
    res["grad_rel"] = max(e / n for e, n in pairs if n > floor)
    res["cancelled_err"] = max([e / (floor / CANCELLED) for e, n in pairs if n <= floor],
                               default=0.0)
    res["leaves"] = len(pairs)
    return res

def run(n: int, device: str = "cuda", threads: Optional[int] = None) -> Dict[str, Any]:
    """The four checks on ``n`` spawned ranks; raises on a failed one."""
    from livetalking_tpu_torch.models import sd_unet

    cfg = sd_unet.UNetConfig(**DRY_UNET)
    rng = np.random.default_rng(0)
    out: Dict[str, Any] = {}
    with pdist.Ranks(n, device=device, threads=threads) as ranks:
        r = ranks.run(wav2lip_train_step, 0)[0]
        out["train_loss"], shape = r["loss"], r["mesh"]
        print(f"dryrun: mesh {shape} over {n} ranks; one sharded Wav2Lip train step OK, "
              f"loss={out['train_loss']:.4f}", flush=True)

        dp = shape[DP_AXIS]
        cycle = rng.integers(0, 255, (4, 256, 256, 3)).astype(np.uint8)
        r = ranks.run(wav2lip_frames, 0, cycle, np.arange(dp, dtype=np.int32) % 4,
                      rng.standard_normal((dp, 80, 16)).astype(np.float32), single=True)[0]
        out["wav2lip_lsb"] = lsb(r["frames"], r["single"])
        _require(out["wav2lip_lsb"] <= 1, f"wav2lip dp infer: {out['wav2lip_lsb']} LSB")
        print(f"dryrun: wav2lip dp infer parity OK (max lsb diff {out['wav2lip_lsb']})", flush=True)

        cyc = rng.standard_normal((4, 16, 16, 8)).astype(np.float32)
        r = ranks.run(musetalk_frames, 1, cfg, cyc, np.arange(dp, dtype=np.int32) % 4,
                      rng.standard_normal((dp, 50, 384)).astype(np.float32), single=True)[0]
        out["musetalk_lsb"] = lsb(r["frames"], r["single"])
        _require(out["musetalk_lsb"] <= 1, f"musetalk dp x tp: {out['musetalk_lsb']} LSB")
        print(f"dryrun: sharded musetalk step OK, frames={r['frames'].shape}, dp x tp vs "
              f"single-device parity OK (max lsb diff {out['musetalk_lsb']})", flush=True)

        r = ranks.run(scheduler_round, 1, cfg)[0]
        out["round_lsb"] = lsb(r["frames"], r["single"])
        _require(r["frames"].shape[1:] == (160, 160, 3) and r["batches"] == 1
                 and out["round_lsb"] <= 1,
                 f"scheduler round: {r['frames'].shape}, {r['batches']} batches, "
                 f"{out['round_lsb']} LSB")
        print(f"dryrun: coalesced scheduler round over dp x tp OK (batches={r['batches']}, "
              f"paste composed, out={r['frames'].shape}, max lsb diff {out['round_lsb']})",
              flush=True)
    return out


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun failed: {what}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser("livetalking_tpu_torch.parallel.dryrun")
    p.add_argument("n", type=int, nargs="?", default=8, help="ranks (devices)")
    p.add_argument("--device", default="cuda", help="cuda (one card per rank) or cpu (gloo)")
    args = p.parse_args(argv)
    threads = max(1, torch.get_num_threads() // args.n) if args.device == "cpu" else None
    run(args.n, args.device, threads)


if __name__ == "__main__":
    main()
