"""LLM bridge (ports livetalking_tpu/llm.py): stream a chat completion and
feed punctuation-split segments to the avatar so TTS starts before the LLM
finishes.

OpenAI-compatible streaming endpoint (DashScope qwen-plus by default), split
on CJK/Latin sentence punctuation, emit segments of > 10 chars via
``put_msg_txt``. Endpoint/model/key come from the environment
(``LLM_BASE_URL`` / ``LLM_MODEL`` / ``DASHSCOPE_API_KEY`` or
``LLM_API_KEY``); ``openai`` is imported on the first call.
"""

from __future__ import annotations

import os
import time
from typing import TYPE_CHECKING, Optional

from livetalking_tpu_torch.utils.logger import logger

if TYPE_CHECKING:  # pragma: no cover
    from livetalking_tpu_torch.avatars.base_avatar import BaseAvatar

_PUNCT = set(",.!;:，。！？：；")
_SYSTEM_PROMPT = "你是一个知识助手，尽量以简短、口语化的方式输出"


def split_into_segments(text_iter, min_len: int = 10):
    """Split a stream of text deltas on punctuation into >=min_len segments.

    Yields complete segments; the trailing remainder (if any) is yielded
    last. Pure function for testability.
    """
    result = ""
    for msg in text_iter:
        if not msg:
            continue
        lastpos = 0
        for i, char in enumerate(msg):
            if char in _PUNCT:
                result += msg[lastpos : i + 1]
                lastpos = i + 1
                if len(result) > min_len:
                    yield result
                    result = ""
        result += msg[lastpos:]
    if result:
        yield result


def llm_response(message: str, avatar_session: "BaseAvatar",
                 datainfo: Optional[dict] = None) -> None:
    datainfo = datainfo or {}
    try:
        start = time.perf_counter()
        from openai import OpenAI

        client = OpenAI(
            api_key=os.getenv("DASHSCOPE_API_KEY") or os.getenv("LLM_API_KEY"),
            base_url=os.getenv(
                "LLM_BASE_URL", "https://dashscope.aliyuncs.com/compatible-mode/v1"
            ),
        )
        logger.info("llm init: %.3fs, %s", time.perf_counter() - start, message)
        completion = client.chat.completions.create(
            model=os.getenv("LLM_MODEL", "qwen-plus"),
            messages=[
                {"role": "system", "content": _SYSTEM_PROMPT},
                {"role": "user", "content": message},
            ],
            stream=True,
            stream_options={"include_usage": True},
        )

        first = True

        def deltas():
            nonlocal first
            for chunk in completion:
                if not chunk.choices:
                    continue
                if first:
                    logger.info("llm time to first chunk: %.3fs", time.perf_counter() - start)
                    first = False
                yield chunk.choices[0].delta.content

        for segment in split_into_segments(deltas()):
            logger.info(segment)
            avatar_session.put_msg_txt(segment, datainfo)
        logger.info("llm time to last chunk: %.3fs", time.perf_counter() - start)
    except Exception:
        logger.exception("llm exception:")
