"""Avatar-generation REST API (ports livetalking_tpu/server/avatar_routes.py).

Contract (reference server/avatar_routes.py:23-136): multipart video
upload to ``./data/tmp``, parameter parsing (model, pads, bbox_shift,
version, notifyurl), async task creation; status / list / delete
endpoints; uniform JSON envelope. The builds run on the device given to
``setup_avatar_routes`` (the web app's ``opt.device``).
"""

from __future__ import annotations

import os
import re
import uuid

from aiohttp import web

from livetalking_tpu_torch.server.routes import json_error as _json_error
from livetalking_tpu_torch.server.routes import json_ok as _json_ok
from livetalking_tpu_torch.server.task_manager import task_manager
from livetalking_tpu_torch.utils.logger import logger

_AVATAR_ID_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")


async def create_avatar_task(request: web.Request) -> web.Response:
    try:
        form = await request.post()
        fileobj = form.get("file")
        if fileobj is None:
            return _json_error("missing video file")
        avatar_id = str(form.get("avatar_id", "") or f"avatar_{uuid.uuid4().hex[:8]}")
        if not _AVATAR_ID_RE.match(avatar_id) or ".." in avatar_id:
            return _json_error("invalid avatar_id (allowed: [A-Za-z0-9_.-], max 64)")

        tmp_dir = os.path.join("data", "tmp")
        os.makedirs(tmp_dir, exist_ok=True)
        video_path = os.path.join(tmp_dir, f"{avatar_id}_{uuid.uuid4().hex[:8]}.mp4")
        with open(video_path, "wb") as f:
            f.write(fileobj.file.read())

        params = {
            "model": str(form.get("model", "musetalk")),
            "video_path": video_path,
            "bbox_shift": int(form.get("bbox_shift", 0) or 0),
            "version": str(form.get("version", "v15")),
            "notifyurl": str(form.get("notifyurl", "") or "") or None,
            # detection backend: auto | s3fd | yunet | haar | center
            # (center = explicit opt-in geometric boxes)
            "face_detector": str(form.get("face_detector", "auto")),
            "face_model": str(form.get("face_model", "") or "") or None,
        }
        pads = form.get("pads")
        if pads:
            params["pads"] = tuple(int(v) for v in str(pads).split(","))
        task = task_manager.add_task(avatar_id, params)
        return _json_ok({"task_id": task.task_id, "avatar_id": avatar_id})
    except Exception as e:
        logger.exception("create_avatar_task exception:")
        return _json_error(str(e))


async def get_avatar_task(request: web.Request) -> web.Response:
    task = task_manager.get_task(request.match_info["task_id"])
    if task is None:
        return _json_error("task not found")
    return _json_ok(task.to_dict())


async def list_avatar_tasks(request: web.Request) -> web.Response:
    return _json_ok({"tasks": task_manager.list_tasks()})


async def delete_avatar_task(request: web.Request) -> web.Response:
    if task_manager.delete_task(request.match_info["task_id"]):
        return _json_ok()
    return _json_error("task not found")


def setup_avatar_routes(app: web.Application, device="cuda") -> None:
    task_manager.device = str(device)
    app.router.add_post("/api/avatar/task", create_avatar_task)
    app.router.add_get("/api/avatar/task/{task_id}", get_avatar_task)
    app.router.add_get("/api/avatar/tasks", list_avatar_tasks)
    app.router.add_delete("/api/avatar/task/{task_id}", delete_avatar_task)
