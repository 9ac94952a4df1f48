"""Server bootstrap: ``python -m livetalking_tpu_torch.app [flags]`` (ports
livetalking_tpu/app.py).

Parse config, check the device (``--device cuda``, the default, raises
when no CUDA device is present), import the avatar plugin module, load the
model and the default avatar once (shared across sessions), warm up the
step, wire the session manager, start the aiohttp server. ``queue`` and
``null`` transports start a session-0 render thread at boot.

``POST /session`` creates a session without WebRTC signaling (returns
``{"sessionid": ...}``) and ``POST /session/close`` stops one. WebRTC
signaling, the chat LLM bridge, recording and ``--profile_dir`` come with
later slices (ROADMAP.md). ``aiohttp`` is imported only by the web app.
"""

from __future__ import annotations

import copy
import importlib
import json
from threading import Event, Thread

from livetalking_tpu_torch import registry
from livetalking_tpu_torch.avatars import AVATAR_MODULES
from livetalking_tpu_torch.config import parse_args
from livetalking_tpu_torch.server.session_manager import MEASURED_CAPACITY, session_manager
from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.logger import logger

opt = None
model = None
global_avatars = {}
_load_avatar = None
_render_threads = {}


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

    app = web.Application(client_max_size=1024**2 * 100)
    app["opt"] = opt
    app.router.add_post("/session", create_session_route)
    app.router.add_post("/session/close", close_session_route)
    setup_routes(app)
    return app


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
        logger.warning("--profile_dir is not ported yet; no trace is written")

    if opt.transport in ("queue", "null"):
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
    loop.run_forever()


if __name__ == "__main__":
    main()
