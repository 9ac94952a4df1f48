"""Shared fixtures of the benchmark's own tests (``python -m pytest ltbench/tests``).

``tiny_cfg`` is a configuration file's contents at test widths: every
structure of MuseTalk v1.5 (four U-Net levels, cross-attention, the VAE,
Whisper's four layers and 1500 positions) with narrow channels.
"""

from __future__ import annotations

import copy
import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def tiny_config() -> dict:
    with open(os.path.join(ROOT, "ltbench", "configs", "musetalk_v15_bf16.json")) as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg["unet"].update(block_out_channels=[32, 64, 96, 96], attention_head_dim=4,
                       cross_attention_dim=64)
    cfg["vae"].update(block_out_channels=[32, 32, 32, 32])
    cfg["whisper"].update(d_model=64, encoder_attention_heads=2, encoder_ffn_dim=128)
    cfg["avatar"].update(frames=6, frame_hw=[120, 160])
    cfg["program"].update(batch_size=4, dtype="float32")
    cfg["check"]["limits"].update(worst_frame_mse=10.0, mean_frame_mse=5.0)
    return cfg


@pytest.fixture
def tiny_cfg():
    return tiny_config()


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
