"""The port's optimizers and schedules (``train/optim.py``) against optax.

The same gradients go to optax and to the port for 5 steps: the MuseTalk
generator's AdamW on its warm-up + cosine schedule (whose first update has
learning rate 0 and moves only the moments), the discriminators' AdamW on
``cosine_decay_schedule(disc_lr, max_steps, 1e-2)`` and plain Adam; the
parameters agree within atol 1e-6 after every step. The schedules agree
with optax's at every count.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from livetalking_tpu.train import musetalk_train as jmt
from livetalking_tpu_torch.train import musetalk_train as tmt
from livetalking_tpu_torch.train import optim
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

CASES = {
    "generator": (lambda: optax.adamw(jmt.make_schedule(1e-3, 2, 6), b1=0.9, b2=0.999,
                                      weight_decay=1e-2),
                  lambda: optim.adamw(tmt.make_schedule(1e-3, 2, 6), weight_decay=1e-2)),
    "discriminator": (lambda: optax.adamw(optax.cosine_decay_schedule(2e-3, 6, 1e-2), b1=0.9,
                                          b2=0.999, weight_decay=1e-2),
                      lambda: optim.adamw(optim.cosine_decay_schedule(2e-3, 6, 1e-2),
                                          weight_decay=1e-2)),
    "adam": (lambda: optax.adam(1e-3), lambda: optim.adam(1e-3)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_optax(case):
    make_j, make_t = CASES[case]
    r = np.random.default_rng(0)
    p0 = {"a": r.standard_normal((4, 3)).astype(np.float32),
          "b": [r.standard_normal(5).astype(np.float32)]}
    grads = [{"a": r.standard_normal((4, 3)).astype(np.float32),
              "b": [r.standard_normal(5).astype(np.float32)]} for _ in range(5)]
    tx = make_j()
    jp = {"a": jnp.asarray(p0["a"]), "b": [jnp.asarray(p0["b"][0])]}
    js = tx.init(jp)
    tp = {"a": torch.from_numpy(p0["a"].copy()), "b": [torch.from_numpy(p0["b"][0].copy())]}
    opt = make_t().init(tp)
    for i, g in enumerate(grads):
        upd, js = tx.update({"a": jnp.asarray(g["a"]), "b": [jnp.asarray(g["b"][0])]}, js, jp)
        jp = optax.apply_updates(jp, upd)
        tp["a"].grad, tp["b"][0].grad = torch.from_numpy(g["a"]), torch.from_numpy(g["b"][0])
        opt.step()
        for got, want in ((tp["a"], jp["a"]), (tp["b"][0], jp["b"][0])):
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=0)
        if case == "generator" and i == 0:  # learning rate 0: nothing moved
            assert np.array_equal(tp["a"].detach().numpy(), p0["a"])
    assert opt.count == 5


def test_schedules_match_optax():
    want_g = jmt.make_schedule(1e-4, 10, 100)
    got_g = tmt.make_schedule(1e-4, 10, 100)
    want_d = optax.cosine_decay_schedule(2e-5, 100, 1e-2)
    got_d = optim.cosine_decay_schedule(2e-5, 100, 1e-2)
    for c in (0, 1, 5, 9, 10, 11, 50, 99, 100, 150):
        assert got_g(c) == pytest.approx(float(want_g(c)), rel=1e-6, abs=1e-12)
        assert got_d(c) == pytest.approx(float(want_d(c)), rel=1e-6, abs=1e-12)
    assert got_g(0) == 0.0 and got_d(100) == pytest.approx(2e-7)


def test_state_dict_round_trip_continues_exactly():
    """An optimizer rebuilt from a saved state (numpy leaves, as the CLI's
    ``.state`` file holds) continues bit for bit."""
    from livetalking_tpu_torch.utils.tree import to_numpy_tree

    def run(n, split=None):
        w = torch.ones(3)
        opt = optim.adamw(tmt.make_schedule(1e-2, 1, 10), weight_decay=1e-2).init([w])
        for i in range(n):
            if i == split:
                saved = to_numpy_tree(opt.state_dict())
                w2 = w.detach().clone()
                opt = optim.adamw(tmt.make_schedule(1e-2, 1, 10), weight_decay=1e-2).init([w2])
                opt.load_state_dict(saved)
                w = w2
            w.grad = torch.full((3,), 0.5 + i)
            opt.step()
        return w.detach()

    assert torch.equal(run(4), run(4, split=2))
