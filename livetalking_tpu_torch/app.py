"""Server bootstrap: ``python -m livetalking_tpu_torch.app [flags]`` (ports
livetalking_tpu/app.py).

Parse config, check the device (``--device cuda``, the default, raises
when no CUDA device is present), import the avatar plugin module, load the
model and the default avatar once (shared across sessions), warm up the
step, wire the session manager, start the aiohttp server. WebRTC signaling
(``POST /offer``) is attached when ``aiortc`` imports (else a warning and no
route); ``rtmp``/``virtualcam``/``queue``/``null`` transports start a
session-0 render thread at boot, and ``rtcpush`` dials out ``--push_url``
for ``--max_session`` sessions. ``/human`` of type ``chat`` goes through
``llm.llm_response``; ``GET /record/{sessionid}`` serves the session's
recording (``data/record/<id>.mp4``).

``POST /session`` creates a session without WebRTC signaling (returns
``{"sessionid": ...}``) and ``POST /session/close`` stops one.
``--profile_dir`` traces the process with ``torch.profiler`` (CPU, and
CUDA on the card) from boot and writes the trace there at exit.
``aiohttp`` is imported only by the web app.
"""

from __future__ import annotations

import atexit
import copy
import importlib
import json
import os
from threading import Event, Thread

from livetalking_tpu_torch import registry
from livetalking_tpu_torch.avatars import AVATAR_MODULES
from livetalking_tpu_torch.avatars.base_avatar import record_path
from livetalking_tpu_torch.config import parse_args
from livetalking_tpu_torch.llm import llm_response
from livetalking_tpu_torch.server.session_manager import MEASURED_CAPACITY, session_manager
from livetalking_tpu_torch.utils import spans
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.logger import logger

opt = None
model = None
global_avatars = {}
_load_avatar = None
_render_threads = {}
rtc_manager = None


def build_avatar_session(sessionid: str, params: dict):
    """Session factory: per-request overrides over a copy of the global opt."""
    opt_this = copy.deepcopy(opt)
    opt_this.sessionid = sessionid

    avatar_id = params.get("avatar", opt.avatar_id)
    opt_this.avatar_id = avatar_id
    if avatar_id not in global_avatars:
        global_avatars[avatar_id] = _load_avatar(avatar_id, opt.data_dir, opt.device)
    avatar_this = global_avatars[avatar_id]

    ref_audio = params.get("refaudio", "")
    if ref_audio:
        opt_this.REF_FILE = ref_audio
        opt_this.REF_TEXT = params.get("reftext", "")
    custom_config = params.get("custom_config", "")
    if custom_config:
        opt_this.customopt = json.loads(custom_config)
    if "batch_size" in params:
        # per-session batch override; under --coalesce a conflicting value
        # is rejected by the shared scheduler (SchedulerConfigError)
        opt_this.batch_size = int(params["batch_size"])

    return registry.create("avatar", opt.model, opt=opt_this, model=model, avatar=avatar_this)


def start_render_thread(sessionid: str) -> Event:
    """Start the per-session render pipeline in a worker thread."""
    quit_event = Event()
    avatar_session = session_manager.get_session(sessionid)
    t = Thread(target=avatar_session.render, args=(quit_event,), daemon=True,
               name=f"render-{sessionid}")
    t.start()
    _render_threads[sessionid] = (t, quit_event)
    return quit_event


def stop_render_thread(sessionid: str, timeout: float = 5.0) -> bool:
    """Stop a session's render pipeline; True when its thread has ended."""
    entry = _render_threads.pop(sessionid, None)
    if entry is None:
        return True
    t, quit_event = entry
    quit_event.set()
    t.join(timeout=timeout)
    return not t.is_alive()


def load_plugin_stack(options):
    """Check the device, import the avatar plugin module and load the model
    and the default avatar (unless it is already in ``global_avatars``)."""
    global opt, model, _load_avatar
    if options.model not in AVATAR_MODULES:
        raise ValueError(f"--model {options.model}: unknown model; choose one of "
                         f"{sorted(AVATAR_MODULES)}")
    resolve_device(options.device)
    opt = options

    mod = importlib.import_module(AVATAR_MODULES[opt.model])
    _load_avatar = mod.load_avatar
    if opt.model == "wav2lip":
        model = mod.load_model(opt.modelfile or f"{opt.models_dir}/wav2lip.pth", opt)
        mod.warm_up(opt.batch_size, model, 256)
    elif opt.model == "musetalk":  # its warm-up runs the graph of its int8 flags
        model = mod.load_model(opt)
        mod.warm_up(opt.batch_size, model, 256, opt)
    elif opt.model == "ultralight":
        model = mod.load_model(opt)
        mod.warm_up(opt.batch_size, model, 160)
    else:  # ernerf
        model = mod.load_model(opt)
        mod.warm_up(opt.batch_size, model, int(getattr(opt, "ernerf_size", 128) or 128))
    if opt.avatar_id not in global_avatars:
        global_avatars[opt.avatar_id] = _load_avatar(opt.avatar_id, opt.data_dir, opt.device)

    session_manager.set_max_session(opt.max_session)
    cap = int(getattr(opt, "capacity_sessions", -1))
    if cap < 0:
        cap = MEASURED_CAPACITY.get(opt.model) or 0
    session_manager.configure_capacity(
        cap or None, str(getattr(opt, "capacity_policy", "warn")))
    session_manager.init_builder(build_avatar_session)


def build_web_app():
    from aiohttp import web

    from livetalking_tpu_torch.server.routes import json_error, json_ok, setup_routes

    async def create_session_route(request: web.Request) -> web.Response:
        """POST /session — create + start a session without WebRTC signaling."""
        try:
            try:
                params = await request.json()
            except json.JSONDecodeError:
                params = {}
            sessionid = await session_manager.create_session(params)
            start_render_thread(sessionid)
            return json_ok({"sessionid": sessionid})
        except Exception as e:
            logger.exception("create_session exception:")
            return json_error(str(e))

    async def close_session_route(request: web.Request) -> web.Response:
        """POST /session/close — stop the render thread and drop the session."""
        try:
            params = await request.json()
            sessionid = params.get("sessionid", "")
            stop_render_thread(sessionid)
            session_manager.remove_session(sessionid)
            return json_ok()
        except Exception as e:
            logger.exception("close_session exception:")
            return json_error(str(e))

    async def download_record(request: web.Request) -> web.StreamResponse:
        """GET /record/{sessionid} — the session's recording, or 404."""
        path = record_path(request.match_info["sessionid"])
        if os.path.exists(path):
            return web.FileResponse(path)
        return web.Response(status=404, text="Record not found")

    app = web.Application(client_max_size=1024**2 * 100)
    app["llm_response"] = llm_response
    app["opt"] = opt

    global rtc_manager
    try:
        from livetalking_tpu_torch.server.rtc_manager import RTCManager
    except ImportError as e:
        logger.warning("WebRTC unavailable (aiortc missing: %s) - /offer disabled", e)
    else:
        rtc_manager = RTCManager(opt)
        app["rtc_manager"] = rtc_manager

        async def offer(request):
            return await rtc_manager.handle_offer(request)

        async def on_shutdown(_app):
            await rtc_manager.shutdown()

        app.router.add_post("/offer", offer)
        app.on_shutdown.append(on_shutdown)

    app.router.add_post("/session", create_session_route)
    app.router.add_post("/session/close", close_session_route)
    app.router.add_get("/record/{sessionid}", download_record)
    setup_routes(app)
    return app


def start_profiler(profile_dir: str, device):
    """Trace CPU activity, and CUDA activity on the card, from now on (the
    port's ``jax.profiler.start_trace``). Returns ``stop()``, which ends the
    trace and writes it to ``<profile_dir>/trace_<pid>.json`` (Chrome
    trace format, TensorBoard and Perfetto read it), with the port's spans
    (``utils/spans.py``) on their threads above the kernels, and returns the
    path; a failure to write is logged at error level and raised."""
    import torch

    os.makedirs(profile_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()

    def stop() -> str:
        prof.stop()
        path = os.path.join(profile_dir, f"trace_{os.getpid()}.json")
        try:
            prof.export_chrome_trace(path)
            spans.add_to_chrome_trace(path)
        except Exception:
            logger.exception("--profile_dir: could not write the trace to %s", path)
            raise
        logger.info("torch.profiler trace written to %s", path)
        return path

    return stop


def main() -> None:
    import asyncio

    from aiohttp import web

    try:
        from dotenv import load_dotenv

        load_dotenv()  # provider keys from .env
    except ImportError:
        pass

    options = parse_args()
    logger.info(options)
    load_plugin_stack(options)
    if opt.profile_dir:
        atexit.register(start_profiler(opt.profile_dir, opt.device))  # written at shutdown
        logger.info("torch.profiler tracing to %s", opt.profile_dir)

    if opt.transport in ("virtualcam", "rtmp", "queue", "null"):
        # boot-time session 0 with a background render thread
        session_manager.add_session("0", build_avatar_session("0", {}))
        start_render_thread("0")

    app = build_web_app()
    logger.info("start http server; http://<serverip>:%d/", opt.listenport)

    loop = asyncio.new_event_loop()
    asyncio.set_event_loop(loop)
    runner = web.AppRunner(app)
    loop.run_until_complete(runner.setup())
    site = web.TCPSite(runner, "0.0.0.0", opt.listenport)
    loop.run_until_complete(site.start())
    if opt.transport == "rtcpush" and rtc_manager is not None:
        for k in range(opt.max_session):
            push_url = opt.push_url if k == 0 else opt.push_url + str(k)
            loop.run_until_complete(rtc_manager.handle_rtcpush(push_url, str(k)))
    loop.run_forever()


if __name__ == "__main__":
    main()
