"""The port's LLM bridge (``llm.py``) against the JAX package's.

``tests/test_llm.py``'s four cases through both packages: the streaming
punctuation splitter (lossless, > 10-char segments ending on punctuation,
the trailing remainder, ``None`` deltas) and ``llm_response`` against a
fake ``openai`` module injected through ``sys.modules``. The segments must
be equal. Then ``/human`` of type ``chat`` on the port's web app reaches
``llm_response`` and feeds the session's TTS queue.
"""

import asyncio
import sys
import time
import types
from unittest.mock import patch

import numpy as np

from livetalking_tpu import llm as jax_llm
from livetalking_tpu_torch import llm
from test_torch_whisper_decoder import torch_one_thread  # noqa: F401

PUNCT = "，。！？：；,.!;:"


def _segments(deltas, **kw):
    got = [list(m.split_into_segments(iter(deltas), **kw)) for m in (jax_llm, llm)]
    assert got[1] == got[0]
    return got[1]


def test_splitter_min_length_and_punctuation():
    deltas = ["你好，", "今天天气", "真不错。", "我们去", "散步吧！"]
    segs = _segments(deltas, min_len=10)
    assert "".join(segs) == "".join(deltas)
    for s in segs[:-1]:
        assert len(s) > 10 and s[-1] in PUNCT
    # seeded random deltas over a mixed alphabet, both packages cut the same
    rng = np.random.default_rng(3)
    alphabet = list("abc 字词，。！？:;,.!")
    text = "".join(rng.choice(alphabet, 400))
    cuts = np.sort(rng.choice(np.arange(1, 400), 40, replace=False))
    deltas = [text[a:b] for a, b in zip([0, *cuts], [*cuts, 400])]
    for min_len in (0, 5, 10, 30):
        assert "".join(_segments(deltas, min_len=min_len)) == text


def test_splitter_trailing_remainder():
    assert _segments(["no punctuation at all"]) == ["no punctuation at all"]


def test_splitter_skips_none_deltas():
    assert "".join(_segments([None, "a,", None, "bbbbbbbbbbb."])) == "a,bbbbbbbbbbb."


TEXT = "第一句话讲完了。第二句话也讲完了。最后一句结束。"


def _fake_openai(chunks, seen):
    class _Delta:
        def __init__(self, c):
            self.content = c

    class _Chunk:
        def __init__(self, c):
            self.choices = [types.SimpleNamespace(delta=_Delta(c))] if c is not None else []

    class _Completions:
        def create(self, **kw):
            seen.append(kw)
            return iter([_Chunk(c) for c in chunks])

    class _FakeClient:
        def __init__(self, **kw):
            seen.append(kw)
            self.chat = types.SimpleNamespace(completions=_Completions())

    mod = types.ModuleType("openai")
    mod.OpenAI = _FakeClient
    return mod


class _Session:
    def __init__(self):
        self.msgs = []

    def put_msg_txt(self, msg, datainfo=None):
        self.msgs.append((msg, datainfo))


def test_llm_response_streams_segments_to_session(monkeypatch):
    """The same streamed completion (a usage-only chunk without choices
    included) through both packages' ``llm_response``: equal segments,
    datainfo passed through, the endpoint and model from the environment."""
    monkeypatch.setenv("LLM_BASE_URL", "http://llm.local/v1")
    monkeypatch.setenv("LLM_MODEL", "m-test")
    monkeypatch.setenv("LLM_API_KEY", "k")
    monkeypatch.delenv("DASHSCOPE_API_KEY", raising=False)
    chunks = [TEXT[i:i + 3] for i in range(0, len(TEXT), 3)] + [None]
    got, seen = [], []
    for mod in (jax_llm, llm):
        sess = _Session()
        with patch.dict(sys.modules, {"openai": _fake_openai(chunks, seen)}):
            mod.llm_response("你好", sess, {"tts": {"speed": 1.0}})
        got.append(sess.msgs)
    assert got[1] == got[0] and got[1]
    assert "".join(m for m, _d in got[1]) == TEXT
    assert all(d == {"tts": {"speed": 1.0}} for _m, d in got[1])
    assert seen[0:2] == seen[2:4]
    assert seen[0] == {"api_key": "k", "base_url": "http://llm.local/v1"}
    assert seen[1]["model"] == "m-test" and seen[1]["stream"] is True
    assert seen[1]["messages"][1] == {"role": "user", "content": "你好"}


def test_llm_response_logs_and_survives_a_failed_client():
    sess = _Session()
    with patch.dict(sys.modules, {"openai": None}):  # not installed
        llm.llm_response("hi", sess)
    assert sess.msgs == []


def test_human_chat_reaches_llm_response(monkeypatch):
    """``POST /human`` with ``type: chat`` on the port's app runs
    ``app["llm_response"]`` (the port's ``llm_response``) in an executor:
    the session's TTS queue receives the completion's segments."""
    from aiohttp.test_utils import TestClient, TestServer

    from livetalking_tpu_torch import app as appmod
    from livetalking_tpu_torch.config import default_opt
    from livetalking_tpu_torch.server.session_manager import session_manager

    monkeypatch.setattr(appmod, "opt", default_opt(device="cpu", transport="queue"))
    chunks = [TEXT[i:i + 4] for i in range(0, len(TEXT), 4)]
    sess = _Session()
    session_manager.add_session("chat0", sess)

    async def scenario():
        web_app = appmod.build_web_app()
        assert web_app["llm_response"] is llm.llm_response
        async with TestClient(TestServer(web_app, host="127.0.0.1")) as client:
            r = await client.post("/human", json={"sessionid": "chat0", "type": "chat",
                                                  "text": "你好", "tts": {"voice": "v"}})
            body = await r.json()
            deadline = time.time() + 10
            while "".join(m for m, _ in sess.msgs) != TEXT and time.time() < deadline:
                await asyncio.sleep(0.02)
            return body

    try:
        with patch.dict(sys.modules, {"openai": _fake_openai(chunks, [])}):
            body = asyncio.run(scenario())
    finally:
        session_manager.remove_session("chat0")
    assert body == {"code": 0, "msg": "ok"}
    assert "".join(m for m, _ in sess.msgs) == TEXT
    assert [m for m, _ in sess.msgs] == list(llm.split_into_segments(iter(chunks)))
    assert all(d == {"tts": {"voice": "v"}} for _m, d in sess.msgs)


def test_prompt_and_punctuation_tables_match():
    assert llm._PUNCT == jax_llm._PUNCT and llm._SYSTEM_PROMPT == jax_llm._SYSTEM_PROMPT
