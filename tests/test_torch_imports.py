"""Import hygiene and device selection of the PyTorch port.

  - No module of ``livetalking_tpu_torch``, and not ``chip_smoke.py``,
    imports ``jax``, ``jaxlib`` or ``livetalking_tpu`` (read with ``ast``,
    function bodies included).
  - No module on the path ``chip_smoke.py`` drives imports ``cv2`` or
    ``aiohttp`` at module level; in a fresh interpreter where both (and
    ``jax``) cannot be imported, every module on that path still imports.
  - ``--device cuda`` on a host without a CUDA device raises at startup,
    as does an unknown ``--model``, and a CUDA request to the paste-back
    raises instead of running the plain version; ``--model musetalk``'s
    int8 flags reach the plugin's warm-up instead of raising.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PKG = "livetalking_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "livetalking_tpu")
HOST_ONLY = ("cv2", "aiohttp")


def _module_name(path: Path) -> str:
    rel = path.relative_to(ROOT).with_suffix("")
    parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
    return ".".join(parts)


SOURCES = {_module_name(p): p for p in sorted((ROOT / PKG).rglob("*.py"))}
SOURCES["chip_smoke"] = ROOT / "chip_smoke.py"


def _imports(tree, module_level_only=False):
    """(module name, imported names) of every import, optionally skipping
    function bodies (which run only when called)."""
    out = []

    def visit(node):
        for child in ast.iter_child_nodes(node):
            if module_level_only and isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                                        ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                out.extend((a.name, ()) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                out.append((child.module, tuple(a.name for a in child.names)))
            visit(child)

    visit(tree)
    return out


def _tree(name):
    return ast.parse(SOURCES[name].read_text(), filename=str(SOURCES[name]))


def _top(mod: str) -> str:
    return mod.split(".")[0]


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_no_jax_and_no_reference_package(name):
    bad = [m for m, _ in _imports(_tree(name)) if _top(m) in FORBIDDEN]
    assert not bad, f"{name} imports {bad}"


def _smoke_path():
    """Modules chip_smoke.py runs: its own imports of the port, the plugin
    modules the app loads by name for the smoke's configuration, every
    package on the way, and their module-level imports, transitively."""
    from livetalking_tpu_torch.avatars import AVATAR_MODULES
    from livetalking_tpu_torch.streamout import OUTPUT_MODULES
    from livetalking_tpu_torch.tts import TTS_MODULES

    def targets(imports):
        for m, names in imports:
            if _top(m) == PKG:
                yield m
                yield from (f"{m}.{n}" for n in names if f"{m}.{n}" in SOURCES)

    todo = list(targets(_imports(_tree("chip_smoke"))))
    todo += [*AVATAR_MODULES.values(), TTS_MODULES["dummy"], OUTPUT_MODULES["queue"]]
    seen = set()
    while todo:
        parts = todo.pop().split(".")
        for i in range(1, len(parts) + 1):
            name = ".".join(parts[:i])
            if name in SOURCES and name not in seen:
                seen.add(name)
                todo += targets(_imports(_tree(name), module_level_only=True))
    return sorted(seen)


SMOKE_PATH = _smoke_path()


def test_smoke_path_covers_the_serving_modules():
    for mod in ("app", "engine.scheduler", "ops.blend", "ops.mel", "models.wav2lip",
                "avatars.wav2lip_avatar", "avatars.base_avatar", "tts.dummy", "streamout.local",
                "server.session_manager", "audio_features.mel_features",
                "avatars.musetalk_avatar", "audio_features.whisper_features",
                "engine.feature_coalescer", "models.musetalk", "models.sd_unet",
                "models.sd_vae", "models.diffusion_blocks", "models.whisper_encoder",
                "ops.attention", "ops.conv", "ops.whisper_mel", "utils.synthetic",
                "avatars.ultralight_avatar", "avatars.ernerf_avatar", "models.hubert",
                "models.ultralight", "models.ernerf", "audio_features.hubert_features"):
        assert f"{PKG}.{mod}" in SMOKE_PATH
    assert f"{PKG}.server.routes" not in SMOKE_PATH  # the HTTP server: aiohttp's


@pytest.mark.parametrize("name", SMOKE_PATH + ["chip_smoke"])
def test_no_module_level_cv2_or_aiohttp_on_the_smoke_path(name):
    imports = _imports(_tree(name), module_level_only=(name != "chip_smoke"))
    bad = [m for m, _ in imports if _top(m) in HOST_ONLY]
    assert not bad, f"{name} imports {bad} at module level"


def test_smoke_path_imports_without_cv2_aiohttp_and_jax():
    code = ("import importlib, sys\n"
            "for m in ('cv2', 'aiohttp', 'jax', 'jaxlib', 'livetalking_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {SMOKE_PATH + ['chip_smoke']!r}:\n"
            "    importlib.import_module(m)\n")
    env = dict(os.environ, LIVETALKING_LOG=os.devnull)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]


def test_device_cuda_without_a_card_raises_at_startup():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    env = dict(os.environ, LIVETALKING_LOG=os.devnull)
    r = subprocess.run([sys.executable, "-m", f"{PKG}.app", "--config", "", "--device", "cuda",
                        "--transport", "queue", "--tts", "dummy"],
                       cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_load_plugin_stack_checks_device_and_model(monkeypatch):
    from livetalking_tpu_torch import app
    from livetalking_tpu_torch.avatars import musetalk_avatar
    from livetalking_tpu_torch.config import default_opt

    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            app.load_plugin_stack(default_opt(device="cuda"))
    with pytest.raises(ValueError, match="unknown model"):
        app.load_plugin_stack(default_opt(model="nosuchmodel", device="cpu"))
    # the int8 flags load and warm the int8 graph (never bf16 in its
    # place); the plugin's own loading is stubbed out here
    warmed = []
    monkeypatch.setattr(musetalk_avatar, "load_model", lambda opt: {"stub": True})
    monkeypatch.setattr(musetalk_avatar, "warm_up",
                        lambda b, model, res, opt=None: warmed.append(opt))
    monkeypatch.setitem(app.global_avatars, "int8_probe", {})
    for flag in ("vae_int8", "unet_int8"):
        opt = default_opt(model="musetalk", device="cpu", avatar_id="int8_probe", **{flag: True})
        app.load_plugin_stack(opt)
        assert warmed[-1] is opt and getattr(warmed[-1], flag)


def test_paste_back_cuda_request_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from livetalking_tpu_torch.ops import blend

    frames = np.zeros((2, 480, 640, 3), np.uint8)
    before = blend.blend_rect_.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        blend.DevicePasteBack(frames, [(120, 360, 200, 440)] * 2, 256, device="cuda")
    with pytest.raises(ValueError):
        blend.blend_rect_(torch.empty((1, 256, 256, 3), dtype=torch.uint8, device="meta"),
                          torch.empty((1, 480, 640, 3), dtype=torch.uint8, device="meta"),
                          torch.empty((1, 4), dtype=torch.int32, device="meta"),
                          Ho=240, Wo=256)
    assert blend.blend_rect_.launches == before
