"""Whisper decoder (tiny by default) with a KV-cached greedy decode: the
text half of the ``/api/asr`` speech-to-text path (ports
livetalking_tpu/models/whisper_decoder.py).

The encoder is the one the MuseTalk feature path runs
(models/whisper_encoder.py); this module adds the autoregressive text
decoder. Parameters are a dictionary of tensors in PyTorch layouts
(linear (out, in)); ``convert_torch_state_dict`` reads an HF
``WhisperModel``/``WhisperDecoder`` state dict, ``params_from_jax`` the
JAX package's tree.

The reference runs the whole greedy loop on the device under one ``jit``
(``lax.while_loop``). Here the loop is a Python loop over fixed-shape
tensors: the position and the step are host integers, so nothing but the
stop test needs the device's values, and that test runs every
``STOP_CHECK_EVERY`` steps. Stopped rows emit EOT, so the extra steps
after the last EOT change no output.
The attention is two plain matmuls with f32 scores, as in the reference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from livetalking_tpu_torch.models.layers import gelu_exact, layer_norm_f32, linear_f32, to_numpy
from livetalking_tpu_torch.utils.device import resolve_device

Params = Dict[str, Any]
Cache = List[Tuple[torch.Tensor, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class WhisperDecoderConfig:
    vocab_size: int = 51865
    d_model: int = 384
    num_layers: int = 4
    num_heads: int = 6
    ffn: int = 1536
    max_target_positions: int = 448
    layer_norm_eps: float = 1e-5
    # special tokens (multilingual tiny layout)
    sot: int = 50258
    eot: int = 50257
    task_transcribe: int = 50359
    no_timestamps: int = 50363
    lang_en: int = 50259
    lang_zh: int = 50260


TINY_DECODER = WhisperDecoderConfig()
STOP_CHECK_EVERY = 8  # decode steps between host reads of the stop flags


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    B, T, D = t.shape
    return t.reshape(B, T, heads, D // heads).transpose(1, 2)


def _merge_heads(t: torch.Tensor) -> torch.Tensor:
    B, H, T, hd = t.shape
    return t.transpose(1, 2).reshape(B, T, H * hd)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask=None) -> torch.Tensor:
    """softmax(q kᵀ) v: f32 scores, probabilities rounded to the activation
    dtype before the value product, f32 accumulation (the reference's
    ``preferred_element_type``)."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if mask is not None:
        s = s.masked_fill(~mask, float("-inf"))
    pr = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(pr.float(), v.float()).to(q.dtype)


def _cached_self_attn(p: Params, x: torch.Tensor, cache_k: torch.Tensor, cache_v: torch.Tensor,
                      pos: int, heads: int) -> torch.Tensor:
    """One-token self-attention against a static-length KV cache.

    x: (B, 1, D). cache_{k,v}: (B, H, T_max, hd), written in place at
    ``pos``; entries at t > pos are masked out of the softmax."""
    hd = x.shape[-1] // heads
    q = _split_heads(linear_f32(p["q"], x) * (hd ** -0.5), heads)
    cache_k[:, :, pos] = _split_heads(linear_f32(p["k"], x), heads)[:, :, 0]
    cache_v[:, :, pos] = _split_heads(linear_f32(p["v"], x), heads)[:, :, 0]
    mask = torch.arange(cache_k.shape[2], device=x.device) <= pos
    o = _attend(q, cache_k, cache_v, mask)
    return linear_f32(p["o"], _merge_heads(o))


def _cross_attn(p: Params, x: torch.Tensor, xk: torch.Tensor, xv: torch.Tensor,
                heads: int) -> torch.Tensor:
    """Cross-attention with precomputed encoder K/V: xk/xv (B, H, S, hd)."""
    hd = x.shape[-1] // heads
    q = _split_heads(linear_f32(p["q"], x) * (hd ** -0.5), heads)
    return linear_f32(p["o"], _merge_heads(_attend(q, xk, xv)))


def precompute_cross_kv(params: Params, cfg: WhisperDecoderConfig, enc: torch.Tensor) -> Cache:
    """Encoder output (B, S, D) -> per-layer cross-attention K/V."""
    return [(_split_heads(linear_f32(lp["xattn"]["k"], enc), cfg.num_heads),
             _split_heads(linear_f32(lp["xattn"]["v"], enc), cfg.num_heads))
            for lp in params["layers"]]


def empty_caches(cfg: WhisperDecoderConfig, B: int, T_max: int, dtype, device) -> Cache:
    hd = cfg.d_model // cfg.num_heads
    shape = (B, cfg.num_heads, T_max, hd)
    return [(torch.zeros(shape, dtype=dtype, device=device),
             torch.zeros(shape, dtype=dtype, device=device)) for _ in range(cfg.num_layers)]


def decode_step(params: Params, cfg: WhisperDecoderConfig, token: torch.Tensor, pos: int,
                caches: Cache, cross_kv: Cache, emb_f32: torch.Tensor = None):
    """One decoder step. token (B,) int; ``pos`` a host int; ``caches`` a
    list of (k, v) per layer, updated in place. Returns (logits (B, V) f32,
    caches). ``emb_f32`` is ``tok_emb`` in f32 when the caller keeps it
    (the logits are f32 against the f32-cast embedding)."""
    eps = cfg.layer_norm_eps
    x = params["tok_emb"][token][:, None, :]
    x = (x + params["pos_emb"][pos]).to(x.dtype)
    for lp, (ck, cv), (xk, xv) in zip(params["layers"], caches, cross_kv):
        x = x + _cached_self_attn(lp["attn"], layer_norm_f32(lp["ln1"], x, eps), ck, cv, pos,
                                  cfg.num_heads)
        x = x + _cross_attn(lp["xattn"], layer_norm_f32(lp["ln_x"], x, eps), xk, xv,
                            cfg.num_heads)
        x = x + linear_f32(lp["fc2"], gelu_exact(linear_f32(
            lp["fc1"], layer_norm_f32(lp["ln2"], x, eps))))
    x = layer_norm_f32(params["ln_post"], x, eps)
    emb = params["tok_emb"].float() if emb_f32 is None else emb_f32
    return torch.matmul(x[:, 0].float(), emb.T), caches


def make_greedy_decode(params: Params, cfg: WhisperDecoderConfig, max_new: int = 128,
                       dtype=torch.bfloat16, no_repeat_ngram: int = 3,
                       repetition_penalty: float = 1.0):
    """Encoder states (B, S, D) + prompt (B, P) int -> (tokens (B, max_new)
    int64, n_valid (B,)), on the device of the parameters. Greedy by
    default; stops at EOT, stopped rows keep emitting EOT.

    The reference's guards (``whisper_decoder.py:140-252``):

    - ``no_repeat_ngram`` (=3): a token that would complete an n-gram
      already in the generated text is banned that step; EOT never is.
    - ``repetition_penalty`` (>1): HF-style down-weighting of emitted tokens.
    - ``temperature`` / ``seed`` are call arguments. At T > 0 Gumbel noise
      comes from a ``torch.Generator`` on the decode's device seeded with
      ``seed`` (its bits are not ``jax.random``'s; only T = 0 is held to
      the reference token for token).

    The stop flags are read on the host every ``STOP_CHECK_EVERY`` steps:
    a decode costs one host sync per ``STOP_CHECK_EVERY`` tokens, and runs
    at most ``STOP_CHECK_EVERY - 1`` steps past the last EOT."""
    ng = int(no_repeat_ngram)
    V, eot = cfg.vocab_size, cfg.eot
    emb_f32 = params["tok_emb"].float()

    @torch.no_grad()
    def fn(enc: torch.Tensor, prompt: torch.Tensor, temperature: float = 0.0, seed: int = 0):
        dev = emb_f32.device
        prompt = torch.as_tensor(prompt, device=dev).long()
        B, P = prompt.shape
        cross_kv = precompute_cross_kv(params, cfg, enc.to(device=dev, dtype=dtype))
        caches = empty_caches(cfg, B, P + max_new, dtype, dev)
        logits = None
        for i in range(P):  # prime the cache with the prompt (last logits kept)
            logits, caches = decode_step(params, cfg, prompt[:, i], i, caches, cross_kv, emb_f32)

        # text tokens + EOT only (ids < eot, and eot); no timestamp / special continuation
        allow = torch.arange(V, device=dev) <= eot
        out = torch.full((B, max_new), eot, dtype=torch.long, device=dev)
        done = torch.zeros(B, dtype=torch.bool, device=dev)
        if repetition_penalty != 1.0:
            rows = torch.arange(B, device=dev)
            seen = torch.zeros((B, V), dtype=torch.bool, device=dev)
        gen = None
        if temperature > 0.0:
            gen = torch.Generator(device=dev)
            gen.manual_seed(int(seed))
        t = max(float(temperature), 1e-6)
        for step in range(max_new):
            if step and step % STOP_CHECK_EVERY == 0 and bool(done.all()):
                break
            masked = torch.where(allow, logits, float("-inf"))
            if repetition_penalty != 1.0:
                pen = torch.where(masked > 0, masked / repetition_penalty,
                                  masked * repetition_penalty)
                masked = torch.where(seen, pen, masked)
            if ng > 1 and step >= ng - 1:
                # ban out[:, j + ng - 1] for every j whose (ng - 1)-gram
                # out[:, j:j + ng - 1] equals the last ng - 1 tokens. The
                # reference's window start is clamped into [0, max_new - ng + 1]
                # (dynamic_slice); its guard j + ng - 1 < step keeps only
                # the first step - ng + 1 positions, the ones sliced here.
                start = min(max(step - (ng - 1), 0), max_new - (ng - 1))
                last = out[:, start:start + ng - 1]
                J = step - (ng - 1)
                if J > 0:
                    cand = torch.stack([out[:, k:J + k] for k in range(ng - 1)], dim=-1)
                    match = (cand == last[:, None, :]).all(dim=-1)
                    tails = out[:, ng - 1:ng - 1 + J]
                    # duplicate tails OR together (the reference's scatter-max)
                    hits = torch.zeros((B, V), dtype=torch.int32, device=dev)
                    hits.scatter_add_(1, tails, match.int())
                    ban = hits > 0
                    ban[:, eot] = False
                    masked = masked.masked_fill(ban, float("-inf"))
            scored = masked / t
            if gen is not None:
                u = torch.rand(masked.shape, generator=gen, device=dev) + 1e-20
                scored = scored + -torch.log(-torch.log(u))
            tok = torch.argmax(scored, dim=-1)
            tok = torch.where(done, torch.full_like(tok, eot), tok)
            out[:, step] = tok
            if repetition_penalty != 1.0:
                seen[rows, tok] = True
                seen[:, eot] = False
            done = done | (tok == eot)
            logits, caches = decode_step(params, cfg, tok, P + step, caches, cross_kv, emb_f32)
        return out, (out != eot).sum(dim=-1)

    return fn


# ---------------------------------------------------------------------------
# init / conversion
# ---------------------------------------------------------------------------


def init_params(seed: int = 0, cfg: WhisperDecoderConfig = TINY_DECODER, dtype=torch.bfloat16,
                device="cpu") -> Params:
    """Random weights from ``torch.Generator(seed)``: N(0, 1/fan_in)
    linears, N(0, 0.02) embeddings, zero biases, unit LayerNorms."""
    g = torch.Generator().manual_seed(seed)
    dev = resolve_device(device)
    D = cfg.d_model

    def t(a):
        return a.to(device=dev, dtype=dtype)

    def lin(i, o, bias=True):
        return {"w": t(torch.randn((o, i), generator=g) / math.sqrt(i)),
                "b": t(torch.zeros(o)) if bias else None}

    def ln():
        return {"g": torch.ones(D, device=dev), "b": torch.zeros(D, device=dev)}

    def attn():
        return {"q": lin(D, D), "k": lin(D, D, bias=False), "v": lin(D, D), "o": lin(D, D)}

    layers = [{"attn": attn(), "xattn": attn(), "ln1": ln(), "ln_x": ln(), "ln2": ln(),
               "fc1": lin(D, cfg.ffn), "fc2": lin(cfg.ffn, D)} for _ in range(cfg.num_layers)]
    return {
        "tok_emb": t(torch.randn((cfg.vocab_size, D), generator=g) * 0.02),
        "pos_emb": t(torch.randn((cfg.max_target_positions, D), generator=g) * 0.02),
        "ln_post": ln(),
        "layers": layers,
    }


def _tensor(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32)).to(device=device, dtype=dtype)


def params_from_jax(tree: Params, dtype=torch.float32, device="cpu") -> Params:
    """The JAX package's tree (leaves as numpy arrays; linears (in, out))
    -> the port's dictionary."""
    dev = resolve_device(device)

    def lin(p):
        return {"w": _tensor(np.asarray(p["w"], np.float32).T, dtype, dev),
                "b": None if p.get("b") is None else _tensor(p["b"], dtype, dev)}

    def ln(p):
        return {"g": _tensor(p["g"], torch.float32, dev), "b": _tensor(p["b"], torch.float32, dev)}

    def attn(p):
        return {k: lin(p[k]) for k in ("q", "k", "v", "o")}

    return {
        "tok_emb": _tensor(tree["tok_emb"], dtype, dev),
        "pos_emb": _tensor(tree["pos_emb"], dtype, dev),
        "ln_post": ln(tree["ln_post"]),
        "layers": [{"attn": attn(lp["attn"]), "xattn": attn(lp["xattn"]),
                    "ln1": ln(lp["ln1"]), "ln_x": ln(lp["ln_x"]), "ln2": ln(lp["ln2"]),
                    "fc1": lin(lp["fc1"]), "fc2": lin(lp["fc2"])} for lp in tree["layers"]],
    }


def convert_torch_state_dict(sd: Dict[str, Any], cfg: WhisperDecoderConfig = TINY_DECODER,
                             dtype=torch.bfloat16, device="cpu") -> Params:
    """HF ``WhisperModel``/``WhisperDecoder`` state dict -> the port's
    dictionary. Keys may carry a ``decoder.``/``model.decoder.`` prefix."""
    dev = resolve_device(device)
    sd = {k: to_numpy(v) for k, v in sd.items()}
    for prefix in ("model.decoder.", "decoder."):
        if any(k.startswith(prefix) for k in sd):
            sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
            break

    def lin(prefix, bias=True):
        return {"w": _tensor(sd[f"{prefix}.weight"], dtype, dev),
                "b": _tensor(sd[f"{prefix}.bias"], dtype, dev) if bias else None}

    def ln(prefix):
        return {"g": _tensor(sd[f"{prefix}.weight"], torch.float32, dev),
                "b": _tensor(sd[f"{prefix}.bias"], torch.float32, dev)}

    def attn(prefix):
        return {"q": lin(f"{prefix}.q_proj"), "k": lin(f"{prefix}.k_proj", bias=False),
                "v": lin(f"{prefix}.v_proj"), "o": lin(f"{prefix}.out_proj")}

    layers = []
    for i in range(cfg.num_layers):
        b = f"layers.{i}"
        layers.append({
            "attn": attn(f"{b}.self_attn"), "xattn": attn(f"{b}.encoder_attn"),
            "ln1": ln(f"{b}.self_attn_layer_norm"), "ln_x": ln(f"{b}.encoder_attn_layer_norm"),
            "ln2": ln(f"{b}.final_layer_norm"),
            "fc1": lin(f"{b}.fc1"), "fc2": lin(f"{b}.fc2"),
        })
    return {
        "tok_emb": _tensor(sd["embed_tokens.weight"], dtype, dev),
        "pos_emb": _tensor(sd["embed_positions.weight"], dtype, dev),
        "ln_post": ln("layer_norm"),
        "layers": layers,
    }
