"""Training CLI (ports livetalking_tpu/train/cli.py): any family's recipe
from the shell.

    python -m livetalking_tpu_torch.train --family musetalk \\
        --avatar_dir data/avatars/my_avatar --wav clip.wav \\
        --steps 2000 --batch_size 8 --recipe full --out unet.pkl

The same flags and behaviour as the reference CLI, plus ``--device``
(``cuda`` by default; without a card it raises, ``--device cpu`` runs on
the CPU). Models come from the avatars' ``load_model`` (checkpoints under
``--models_dir``, random weights from fixed seeds without them);
``--synthetic N`` trains on N random frames and a synthetic tone.

Checkpoints are pickles of numpy trees. ``--out`` writes the trained
weights in the port's layout, marked (``utils/checkpoint.py``), and
``--out``.state the whole train state: the port's optimizer states, the
step and the data sampler's random state, so ``--resume`` continues the
run exactly (N + M steps give what N + M steps in one run give).
``--init`` and ``--sync_init`` read a weights tree written by either
package: a tree in the JAX package's layout goes through the family's
``params_from_jax``.

``--mesh dp=N[,tp=M]`` trains on N*M ranks, one per device (NCCL on the
card; gloo ranks with ``--device cpu``): spawned here, or joined when a
launcher (``torchrun``) started this process. Every rank draws the same
global batch from ``--seed`` and takes its dp slice, cut at clip
boundaries (dp must divide the clips: a clip's sync and GAN terms do not
split); the parameters are whole on every rank, and the tp ranks of a dp
slice compute the same slice, as the JAX package's ``shard_batch`` does.
Gradients are summed over dp in flattened buckets and divided by dp
before each optimizer step, so the parameters stay bit-equal on every
rank (checked at every logged step and at the end). The losses are batch
means over equal slices, so their dp mean is the global batch's. Only
rank 0 logs and writes ``--out`` and its ``.state``.
"""

from __future__ import annotations

import argparse
import functools
import math
import time
from types import SimpleNamespace
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from livetalking_tpu_torch.utils.logger import logger

def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser("livetalking_tpu_torch.train")
    p.add_argument("--family", required=True, choices=["wav2lip", "musetalk", "ultralight"])
    p.add_argument("--avatar_dir", default="", help="avatar directory (genavatar format)")
    p.add_argument("--wav", default="", help="16 kHz training utterance")
    p.add_argument("--synthetic", type=int, default=0,
                   help="train on N synthetic frames instead of real data")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--recipe", default="l1", choices=["l1", "full"])
    p.add_argument("--init", default="",
                   help=".pkl weights tree (either package's) for a weights-only warm start "
                        "(optimizer state and schedule restart at step 0; use --resume for "
                        "an exact continuation)")
    p.add_argument("--resume", default="",
                   help=".state file written next to --out (params + optimizer state + step "
                        "+ sampler state); resumes the run exactly where it left off")
    p.add_argument("--sync_init", default="",
                   help=".pkl with TRAINED SyncNet weights for the full recipe's frozen sync "
                        "expert. Without it the sync term is DISABLED (weight 0): a random "
                        "expert would pull the generator toward a random alignment. For "
                        "--sync_backend musetalk a torch .pt/.pth checkpoint is converted")
    p.add_argument("--sync_backend", default="generic", choices=["generic", "musetalk"],
                   help="musetalk (family musetalk only): the dedicated ResNet/attention "
                        "expert on 16-frame clips (models/musetalk_syncnet.py)")
    p.add_argument("--out", default="", help="checkpoint output path (.pkl)")
    p.add_argument("--models_dir", default="./models")
    p.add_argument("--size", default="full", choices=["full", "tiny"],
                   help="tiny shrinks the U-Net/feature nets (tests, smoke)")
    p.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    p.add_argument("--mesh", default="",
                   help="dp x tp mesh, e.g. dp=2 or dp=2,tp=2: one rank per device (spawned, "
                        "or joined under torchrun); the batch is cut over dp")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--log_every", type=int, default=20)
    p.add_argument("--save_every", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    return p.parse_args(argv)


def _load_audio(args, n_frames: int) -> np.ndarray:
    if args.wav:
        from livetalking_tpu_torch.utils.audio import load_pcm16k

        return load_pcm16k(args.wav)
    t = np.arange(int(16000 * n_frames / 25.0)) / 16000.0
    return (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.1 * np.sin(2 * np.pi * 523 * t)).astype(np.float32)


def _faces(args, family: str, rng) -> np.ndarray:
    from livetalking_tpu_torch.train import data as td

    if args.synthetic:
        S = 160 if family == "ultralight" else 256
        return rng.randint(0, 255, (args.synthetic, S, S, 3), dtype=np.uint8)
    if not args.avatar_dir:
        raise SystemExit("need --avatar_dir or --synthetic N")
    return td.load_faces(args.avatar_dir, family)


def _read_weights(path: str, from_jax: Callable, dev, like=None, dtype=None):
    """A weights file written by either package -> the port's parameters on
    ``dev``: a tree, or the module ``like`` loaded with the port's state
    dict (a JAX-layout tree goes through ``from_jax``)."""
    from livetalking_tpu_torch.utils.checkpoint import load_params
    from livetalking_tpu_torch.utils.tree import to_torch_tree

    tree, port = load_params(path)
    if not port:
        return from_jax(tree)
    if like is None:
        return to_torch_tree(tree, dev, dtype)
    like.load_state_dict(to_torch_tree(tree))
    return like.to(dev)


def _load_sync_expert(args, use_mt_sync: bool, dev):
    from livetalking_tpu_torch.models import musetalk_syncnet as msn
    from livetalking_tpu_torch.models import syncnet

    if use_mt_sync and args.sync_init.endswith((".pt", ".pth")):
        return msn.convert_torch_state_dict(
            torch.load(args.sync_init, map_location="cpu", weights_only=True), device=dev)
    if use_mt_sync:
        return _read_weights(args.sync_init, lambda t: msn.params_from_jax(t, device=dev), dev,
                             dtype=torch.float32)
    img = 160 if args.family == "ultralight" else 256
    return _read_weights(args.sync_init, lambda t: syncnet.params_from_jax(t, device=dev), dev,
                         like=syncnet.SyncNet(img))


def _clip_len(args) -> int:
    if args.recipe != "full":
        return 1
    return 16 if args.family == "musetalk" and args.sync_backend == "musetalk" else 5


def _check_batch(args) -> None:
    """The batch must hold whole clips, and with ``--mesh`` split over dp
    at clip boundaries."""
    clip_len = _clip_len(args)
    if args.batch_size % clip_len:
        raise SystemExit(
            f"--recipe full samples {clip_len}-frame clips: --batch_size must be a multiple "
            f"of {clip_len} (got {args.batch_size}; try "
            f"{((args.batch_size + clip_len - 1) // clip_len) * clip_len})")
    if args.mesh:
        from livetalking_tpu_torch.parallel.mesh import DP_AXIS, parse_mesh_spec

        dp = parse_mesh_spec(args.mesh).get(DP_AXIS, 1)
        clips = args.batch_size // clip_len
        if clips % dp:
            raise SystemExit(
                f"--mesh {args.mesh}: --batch_size {args.batch_size} is {clips} clip(s) of "
                f"{clip_len} frame(s), which do not split over dp={dp} (a clip's sync and "
                f"GAN terms cannot be cut); use a multiple of {clip_len * dp}")


def main(argv=None, on_step: Optional[Callable[[int, Dict[str, float]], None]] = None
         ) -> Dict[str, Any]:
    """Run the CLI; returns the last step's metrics as floats. ``on_step(i,
    metrics)`` is called after each step, once its metrics are on the host
    (after the ranks finished, in step order, when ``--mesh`` spawned
    them)."""
    args = parse_args(argv)
    _check_batch(args)
    if not args.mesh:
        return train(args, on_step=on_step)["metrics"]
    from livetalking_tpu_torch.parallel import dist as pdist
    from livetalking_tpu_torch.parallel.mesh import make_mesh, parse_mesh_spec

    if pdist.current() is not None or pdist.launched():
        pdist.join(args.device)
        return train(args, make_mesh(args.mesh), on_step)["metrics"]
    world = math.prod(parse_mesh_spec(args.mesh).values())
    threads = max(1, torch.get_num_threads() // world) if args.device == "cpu" else None
    results = pdist.launch(_mesh_rank, world, device=args.device, threads=threads,
                           args=(list(argv) if argv is not None else None,))
    history = results[0]["history"]
    if on_step is not None:
        for i, m in history:
            on_step(i, m)
    return history[-1][1] if history else {}


def _mesh_rank(argv) -> Dict[str, Any]:
    """One spawned rank of ``main``: its training run's metrics history."""
    from livetalking_tpu_torch.parallel.mesh import make_mesh

    args = parse_args(argv)
    out = train(args, make_mesh(args.mesh))
    return {"history": out["history"]}


def train(args, mesh=None, on_step: Optional[Callable[[int, Dict[str, float]], None]] = None
          ) -> Dict[str, Any]:
    """The training run of ``args`` (parsed flags), on ``mesh``'s rank when
    one is given: ``{"metrics": last step's, "history": [(step, metrics)],
    "optimizers": {name: optim.Optimizer}}``."""
    from livetalking_tpu_torch.train import data as td
    from livetalking_tpu_torch.utils.checkpoint import load_pytree, save_params, save_pytree
    from livetalking_tpu_torch.utils.device import resolve_device
    from livetalking_tpu_torch.utils.tree import to_torch_tree

    _check_batch(args)
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    lead = mesh is None or mesh.rank == 0
    rng = np.random.RandomState(args.seed)
    opt = SimpleNamespace(models_dir=args.models_dir, dtype=args.dtype, device=str(dev),
                          musetalk_size=args.size,
                          hubert_size="tiny" if args.size == "tiny" else "large")
    faces = _faces(args, args.family, rng)
    audio = _load_audio(args, faces.shape[0])
    full = args.recipe == "full"
    use_mt_sync = args.family == "musetalk" and args.sync_backend == "musetalk"
    clip_len = _clip_len(args)
    sync_p = None
    # the frozen sync expert is only meaningful with TRAINED weights; without
    # --sync_init its weight is 0 so a random expert cannot drag the generator
    if full and args.sync_init:
        sync_p = _load_sync_expert(args, use_mt_sync, dev)
    elif full and lead:
        logger.warning("full recipe without --sync_init: sync expert weight set to 0 (train a "
                       "SyncNet first - train/syncnet_train.py - and pass its checkpoint to "
                       "enable the sync loss)")

    if args.family == "wav2lip":
        from livetalking_tpu_torch.models import syncnet, wav2lip_disc
        from livetalking_tpu_torch.models import wav2lip as w2l
        from livetalking_tpu_torch.train import wav2lip_train as wt

        feats = td.mel_windows(audio)
        model = (_read_weights(args.init, w2l.params_from_jax, dev, like=w2l.Wav2Lip())
                 if args.init else w2l.init_model(0))
        params = model.to(dev).train()
        if full:
            tx_g, tx_d, raw = wt.make_full_train_step(
                gen_lr=args.lr, sync_wt=0.03 if sync_p is not None else 0.0)
            disc_p = wav2lip_disc.init_params(1, device=dev)
            if sync_p is None:  # placeholder; sync_wt=0 ignores it
                sync_p = syncnet.init_params(2, device=dev)
            g_opt, d_opt = tx_g.init(params), tx_d.init(disc_p)

            def step(b):
                return raw(params, disc_p, sync_p, g_opt, d_opt, b)[4]

            snap = {"params": params, "disc": disc_p}
            opts = {"g_opt": g_opt, "d_opt": d_opt}
        else:
            tx, raw = wt.make_train_step(args.lr)
            opt_state = tx.init(params)

            def step(b):
                return {"loss": raw(params, opt_state, b)[2]}

            snap, opts = {"params": params}, {"opt_state": opt_state}

        def current():
            return params.state_dict()

    elif args.family == "musetalk":
        from livetalking_tpu_torch.avatars.musetalk_avatar import load_model
        from livetalking_tpu_torch.models import sd_unet
        from livetalking_tpu_torch.train import musetalk_train as mt

        model = load_model(opt)
        feats = td.whisper_windows(audio, model["whisper_params"], model["whisper_cfg"])
        weights = (mt.LossWeights(sync=0.1 if sync_p is not None else 0.0, gan=0.05,
                                  mouth_gan=0.05)
                   if full else mt.LossWeights(perceptual=0.0))
        txs, raw = mt.make_train_step(model["unet_cfg"], weights, lr=args.lr,
                                      max_steps=args.steps, sync_backend=args.sync_backend)
        pdtype = model["dtype"]
        unet0 = (_read_weights(args.init, lambda t: sd_unet.params_from_jax(t, pdtype, dev),
                               dev, dtype=pdtype)
                 if args.init else model["unet_params"])
        state = mt.init_train_state(1, model["unet_cfg"], txs, weights, unet_params=unet0,
                                    device=dev)
        vae_p = model["vae_params"]

        def step(b):
            return raw(state, vae_p, sync_p, b)[1]

        snap = {"unet": state.unet, "face_disc": state.face_disc,
                "mouth_disc": state.mouth_disc}
        opts = {k: getattr(state, k) for k in ("unet_opt", "face_disc_opt", "mouth_disc_opt")
                if getattr(state, k) is not None}

        def current():
            return state.unet

    else:  # ultralight
        from livetalking_tpu_torch.avatars.ultralight_avatar import load_model
        from livetalking_tpu_torch.models import syncnet, ultralight
        from livetalking_tpu_torch.train import ultralight_train as ut

        model = load_model(opt)
        feats = td.hubert_windows(audio, model["hubert_params"], model["hubert_cfg"])
        params = (_read_weights(args.init, lambda t: ultralight.params_from_jax(t, device=dev),
                                dev, dtype=torch.float32)
                  if args.init else ultralight.init_params(0, torch.float32, dev))
        if full:
            tx, raw = ut.make_full_train_step(lr=args.lr,
                                              sync_wt=0.3 if sync_p is not None else 0.0)
            if sync_p is None:  # placeholder; sync_wt=0 ignores it
                sync_p = syncnet.init_params(2, 160, device=dev)
            opt_state = tx.init(params)

            def step(b):
                return raw(params, sync_p, opt_state, b)[2]
        else:
            tx, raw = ut.make_train_step(args.lr)
            opt_state = tx.init(params)

            def step(b):
                return {"loss": raw(params, opt_state, b)[2]}

        snap, opts = {"params": params}, {"opt_state": opt_state}

        def current():
            return params

    if mesh is not None:
        from livetalking_tpu_torch.parallel.mesh import all_reduce_mean

        for o in opts.values():
            o.reduce_grads = functools.partial(all_reduce_mean, mesh)
        trained = [p for o in opts.values() for p in o.params]
    start = 0
    if args.resume:  # exact continuation: params, optimizer states, step, sampler
        st = load_pytree(args.resume)
        _restore(snap, st["snap"])
        for k, o in opts.items():
            o.load_state_dict(st["opts"][k])
        rng.set_state(st["rng"])
        start = int(st["step"])
        if lead:
            logger.info("resumed full train state from %s at step %d", args.resume, start)

    it = td.clip_batches(args.family, faces, np.asarray(feats), args.batch_size, rng,
                         clip_len=clip_len, audio=audio if full else None)

    def save_all(i, rng_state):
        save_params(args.out, current())  # serving-loadable weights
        save_pytree(args.out + ".state",
                    {"step": i, "snap": _snapshot(snap), "rng": rng_state,
                     "opts": {k: o.state_dict() for k, o in opts.items()}})

    t0 = time.time()
    metrics: Dict[str, Any] = {}
    history = []
    for i in range(start, args.steps):
        batch = next(it)
        if mesh is not None:
            from livetalking_tpu_torch.parallel.mesh import shard_batch

            batch = shard_batch(batch, mesh)  # this rank's whole clips
        rng_state = rng.get_state()  # the sampler's state after this step's batch
        metrics = _mean_over_dp(mesh, step(to_torch_tree(batch, dev)))
        history.append((i, metrics))
        if on_step is not None:
            on_step(i, metrics)
        logged = args.log_every and (i % args.log_every == 0 or i == args.steps - 1)
        if mesh is not None and (logged or i == args.steps - 1):
            from livetalking_tpu_torch.parallel.mesh import check_replicas

            check_replicas(mesh, trained, i + 1)
        if logged and lead:
            rate = (i + 1 - start) / (time.time() - t0)
            logger.info("train[%s] step %d/%d %s (%.2f steps/s)", args.family, i + 1,
                        args.steps, " ".join(f"{k}={v:.4f}" for k, v in metrics.items()), rate)
        if args.out and args.save_every and (i + 1) % args.save_every == 0 and lead:
            save_all(i + 1, rng_state)
    if args.out and lead:
        save_all(args.steps, rng.get_state())
        logger.info("saved checkpoint to %s (+ .state for --resume)", args.out)
    return {"metrics": metrics, "history": history, "optimizers": opts}


def _mean_over_dp(mesh, metrics: Dict[str, Any]) -> Dict[str, float]:
    """The step's metrics as floats; under a mesh their mean over dp (each
    is a batch mean over equal slices, so this is the global batch's)."""
    if mesh is None or mesh.shape["dp"] == 1:
        return {k: float(v) for k, v in metrics.items()}
    keys = sorted(metrics)
    v = torch.stack([torch.as_tensor(metrics[k], dtype=torch.float64).detach().reshape(())
                     .to(mesh.device) for k in keys])
    v = mesh.all_reduce_(v, "dp") / mesh.shape["dp"]
    return dict(zip(keys, v.tolist()))


def _snapshot(snap: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (v.state_dict() if isinstance(v, torch.nn.Module) else v)
            for k, v in snap.items()}


def _restore(snap: Dict[str, Any], saved: Dict[str, Any]) -> None:
    """Copy saved leaves into the live parameters, in place (the optimizers
    hold these tensors)."""
    from livetalking_tpu_torch.utils.tree import tree_leaves

    for k, live in snap.items():
        if isinstance(live, torch.nn.Module):
            live.load_state_dict({n: torch.as_tensor(a) for n, a in saved[k].items()})
            continue
        with torch.no_grad():
            for dst, src in zip(tree_leaves(live), tree_leaves(saved[k]), strict=True):
                dst.copy_(torch.as_tensor(src))


if __name__ == "__main__":
    main()
