"""Business API routes (ports livetalking_tpu/server/routes.py).

Uniform ``{"code":0,"msg":"ok","data":...}`` JSON envelope; endpoints
``/human`` ``/humanaudio`` ``/set_audiotype`` ``/record`` (answers with
the error envelope until recording is ported) ``/interrupt_talk``
``/is_speaking`` ``/sse`` ``/api/admin/config`` ``/api/admin/sessions``
``/api/admin/metrics`` plus static files from ``web/``. The ASR and
avatar-task routes come with later slices. ``aiohttp`` is imported here,
and only the web app imports this module.
"""

from __future__ import annotations

import asyncio
import json
import os
import queue

from aiohttp import web

from livetalking_tpu_torch.server.session_manager import session_manager
from livetalking_tpu_torch.utils.logger import logger


def json_ok(data=None) -> web.Response:
    body = {"code": 0, "msg": "ok"}
    if data is not None:
        body["data"] = data
    return web.Response(content_type="application/json", text=json.dumps(body))


def json_error(msg: str, code: int = -1) -> web.Response:
    return web.Response(
        content_type="application/json",
        text=json.dumps({"code": code, "msg": str(msg)}),
    )


def _get_session(sessionid):
    # sessions are keyed by string; reference clients send the sessionid
    # back as a JSON number (reference web/client.js posts the integer it
    # got from /offer), so coerce before the lookup
    return session_manager.get_session(str(sessionid))


async def human(request: web.Request) -> web.Response:
    """Text input: type=echo speaks the text; type=chat routes through the
    LLM bridge; ``interrupt`` flushes in-flight speech; ``tts`` params pass
    through to the TTS plugin."""
    try:
        params = await request.json()
        avatar_session = _get_session(params.get("sessionid", ""))
        if avatar_session is None:
            return json_error("session not found")

        if params.get("interrupt"):
            avatar_session.flush_talk()

        datainfo = {}
        if params.get("tts"):
            datainfo["tts"] = params.get("tts")

        if params["type"] == "echo":
            avatar_session.put_msg_txt(params["text"], datainfo)
        elif params["type"] == "chat":
            llm_response = request.app.get("llm_response")
            if llm_response:
                asyncio.get_event_loop().run_in_executor(
                    None, llm_response, params["text"], avatar_session, datainfo
                )
        return json_ok()
    except Exception as e:
        logger.exception("human route exception:")
        return json_error(str(e))


async def interrupt_talk(request: web.Request) -> web.Response:
    try:
        params = await request.json()
        avatar_session = _get_session(params.get("sessionid", ""))
        if avatar_session is None:
            return json_error("session not found")
        avatar_session.flush_talk()
        return json_ok()
    except Exception as e:
        logger.exception("interrupt_talk exception:")
        return json_error(str(e))


async def humanaudio(request: web.Request) -> web.Response:
    try:
        form = await request.post()
        sessionid = str(form.get("sessionid", ""))
        fileobj = form["file"]
        filebytes = fileobj.file.read()
        avatar_session = _get_session(sessionid)
        if avatar_session is None:
            return json_error("session not found")
        avatar_session.put_audio_file(filebytes, {})
        return json_ok()
    except Exception as e:
        logger.exception("humanaudio exception:")
        return json_error(str(e))


async def set_audiotype(request: web.Request) -> web.Response:
    try:
        params = await request.json()
        avatar_session = _get_session(params.get("sessionid", ""))
        if avatar_session is None:
            return json_error("session not found")
        avatar_session.set_custom_state(params["audiotype"])
        return json_ok()
    except Exception as e:
        logger.exception("set_audiotype exception:")
        return json_error(str(e))


async def record(request: web.Request) -> web.Response:
    try:
        params = await request.json()
        avatar_session = _get_session(params.get("sessionid", ""))
        if avatar_session is None:
            return json_error("session not found")
        if params["type"] == "start_record":
            avatar_session.start_recording()
        elif params["type"] == "end_record":
            avatar_session.stop_recording()
        return json_ok()
    except Exception as e:
        logger.exception("record exception:")
        return json_error(str(e))


async def is_speaking(request: web.Request) -> web.Response:
    params = await request.json()
    avatar_session = _get_session(params.get("sessionid", ""))
    if avatar_session is None:
        return json_error("session not found")
    return json_ok(data=avatar_session.is_speaking())


async def sse_handler(request: web.Request) -> web.StreamResponse:
    """Server-sent events: eventpoints fire at playback time and fan out to
    every subscribed client queue."""
    sessionid = request.query.get("sessionid", "")
    avatar_session = session_manager.get_session(sessionid)
    if avatar_session is None:
        return json_error("session not found")

    response = web.StreamResponse(
        status=200,
        reason="OK",
        headers={
            "Content-Type": "text/event-stream",
            "Cache-Control": "no-cache",
            "Connection": "keep-alive",
            "Access-Control-Allow-Origin": "*",
        },
    )
    await response.prepare(request)

    msgqueue: queue.Queue = queue.Queue()
    avatar_session.add_msgqueue(msgqueue)
    try:
        while True:
            try:
                msg = msgqueue.get_nowait()
                await response.write(f"data: {msg}\n\n".encode("utf-8"))
            except queue.Empty:
                await asyncio.sleep(0.01)
    except (asyncio.CancelledError, ConnectionResetError):
        logger.info("SSE connection closed for session: %s", sessionid)
    finally:
        if msgqueue in avatar_session.msgqueues:
            avatar_session.msgqueues.remove(msgqueue)
    return response


async def admin_config(request: web.Request) -> web.Response:
    try:
        opt = request.app.get("opt")
        if opt:
            return json_ok(data={"config": vars(opt)})
        return json_error("Config not found")
    except Exception as e:
        logger.exception("admin_config exception:")
        return json_error(str(e))


async def admin_sessions(request: web.Request) -> web.Response:
    try:
        sessions_info = []
        for sid, avatar_session in session_manager.sessions.items():
            if avatar_session is None:
                continue
            s_opt = getattr(avatar_session, "opt", None)
            info = {
                "sessionid": sid,
                "speaking": avatar_session.is_speaking(),
                "recording": getattr(avatar_session, "recording", False),
            }
            if s_opt:
                info.update({
                    "model": getattr(s_opt, "model", ""),
                    "avatar_id": getattr(s_opt, "avatar_id", ""),
                    "REF_FILE": getattr(s_opt, "REF_FILE", ""),
                    "transport": getattr(s_opt, "transport", ""),
                    "batch_size": getattr(s_opt, "batch_size", 0),
                    "customopt": getattr(s_opt, "customopt", []),
                })
            sessions_info.append(info)
        data = {"sessions": sessions_info}
        if session_manager.capacity is not None:
            # measured real-time admission state (docs/serving.md):
            # operators see capacity pressure here before users see
            # degraded fps
            data["capacity"] = {
                "measured_sessions": session_manager.capacity,
                "policy": session_manager.capacity_policy,
                "over_capacity": session_manager.over_capacity,
            }
        return json_ok(data=data)
    except Exception as e:
        logger.exception("admin_sessions exception:")
        return json_error(str(e))


async def admin_metrics(request: web.Request) -> web.Response:
    """Process-wide runtime metrics: device, sessions, and (when coalesce
    mode is active) the shared scheduler's batch counters."""
    try:
        import numpy as np
        import torch

        from livetalking_tpu_torch.avatars import wav2lip_avatar

        data: dict = {"sessions": len([s for s in session_manager.sessions.values()
                                       if s is not None])}
        opt = request.app.get("opt")
        backend = getattr(opt, "device", "cuda")
        data["backend"] = backend
        if backend == "cuda":
            data["device_name"] = torch.cuda.get_device_name()
            data["devices"] = torch.cuda.device_count()
        else:
            data["devices"] = 1
        sched = wav2lip_avatar._shared.get("scheduler")
        if sched is not None:
            info = {
                "batches_run": sched.batches_run,
                "requests_run": sched.requests_run,
                "frames_run": sched.frames_run,
                "buckets": list(sched.buckets),
            }
            lat = list(sched.latency_s)
            if lat:
                arr = np.asarray(lat, np.float64)
                info["latency_ms"] = {
                    "p50": round(float(np.percentile(arr, 50)) * 1e3, 1),
                    "p90": round(float(np.percentile(arr, 90)) * 1e3, 1),
                    "p99": round(float(np.percentile(arr, 99)) * 1e3, 1),
                    "n": int(arr.size),
                }
            bsz = list(sched.batch_sizes)
            if bsz:
                info["mean_coalesced_sessions"] = round(sum(bsz) / len(bsz), 2)
            data["wav2lip_scheduler"] = info
        return json_ok(data=data)
    except Exception as e:
        logger.exception("admin_metrics exception:")
        return json_error(str(e))


def setup_routes(app: web.Application, web_root: str = "web") -> None:
    app.router.add_post("/human", human)
    app.router.add_get("/api/admin/metrics", admin_metrics)
    app.router.add_post("/humanaudio", humanaudio)
    app.router.add_post("/set_audiotype", set_audiotype)
    app.router.add_post("/record", record)
    app.router.add_post("/interrupt_talk", interrupt_talk)
    app.router.add_post("/is_speaking", is_speaking)
    app.router.add_get("/api/admin/config", admin_config)
    app.router.add_get("/api/admin/sessions", admin_sessions)
    app.router.add_get("/sse", sse_handler)

    if not os.path.isdir(web_root):
        # fall back to the repo-root web/ dir regardless of cwd
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        web_root = os.path.join(repo_root, "web")
    if os.path.isdir(web_root):
        app.router.add_static("/", path=web_root)
