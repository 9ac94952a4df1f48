"""The port's training CLI on the CPU for Wav2Lip (both recipes) and
MuseTalk (L1, on a narrow VAE that ``--models_dir`` holds in the reference
layout; its full recipe runs a 256 px VAE on 5 frames, which the card runs
in chip_smoke.py and test_torch_musetalk_recipe.py holds at the step),
tiny synthetic runs, and ``--init`` of a Wav2Lip tree in the JAX package's
layout (the port's own is a module state dict).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from livetalking_tpu.models import wav2lip as jw2l
from livetalking_tpu_torch.models import wav2lip as tw2l
from livetalking_tpu_torch.train import cli
from livetalking_tpu_torch.utils.checkpoint import load_params
from test_sd_converters import TorchVAE, _init
from test_torch_train_cli import BASE, check_family_run, np_pickle
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401


def narrow_vae_dir(root):
    """A models directory holding a narrow VAE (channels (32, 32, 64, 64))
    as ``diffusion_pytorch_model.bin``: ``load_model`` reads it."""
    vdir = root / "sd-vae-ft-mse"
    vdir.mkdir(parents=True)
    torch.save(_init(TorchVAE(ch=(32, 32, 64, 64)), seed=1).state_dict(),
               vdir / "diffusion_pytorch_model.bin")
    return str(root)


@pytest.mark.parametrize("family,recipe,batch", [
    ("wav2lip", "l1", 1), ("wav2lip", "full", 5), ("musetalk", "l1", 1)])
def test_each_family_trains_and_saves(tmp_path, family, recipe, batch):
    extra = (["--models_dir", narrow_vae_dir(tmp_path / "models")] if family == "musetalk"
             else [])
    check_family_run(tmp_path, family, recipe, batch, extra)


def test_wav2lip_init_from_a_jax_layout_tree(tmp_path):
    wpath = str(tmp_path / "jax_w2l.pkl")
    jw = jax.jit(lambda k: jw2l.init_params(k, jnp.float32))(jax.random.PRNGKey(4))
    np_pickle(wpath, jw)
    wout = str(tmp_path / "w2l.pkl")
    cli.main(["--family", "wav2lip", "--steps", "1", "--batch_size", "1", "--lr", "0",
              "--init", wpath, "--out", wout] + BASE)
    want = tw2l.params_from_jax(jax.tree.map(np.asarray, jw)).state_dict()
    got = load_params(wout)[0]
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k].numpy()) for k in got)


