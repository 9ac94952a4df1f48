"""Async avatar-build task manager (ports livetalking_tpu/server/task_manager.py).

Contract (reference server/task_manager.py:11-139): in-memory task table,
single-worker executor (avatar builds are resource-heavy), task statuses
pending -> running -> completed/failed with 0-100 progress, and a webhook
(``notifyurl``) POSTed on every status transition: ``task.to_dict()`` as
JSON, 5 s timeout, a failure logged and never raised (``urllib.request``
of the standard library).

The builds run on ``device`` (the card unless the manager is told
otherwise). ``add_task`` checks the device before it queues the task, so
a CUDA request without a card raises to the caller.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
import uuid
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional

from livetalking_tpu_torch.utils.device import resolve_device
from livetalking_tpu_torch.utils.logger import logger

WEBHOOK_TIMEOUT_S = 5


class AvatarTask:
    def __init__(self, avatar_id: str, params: Dict[str, Any]):
        self.task_id = str(uuid.uuid4())
        self.avatar_id = avatar_id
        self.params = params
        self.status = "pending"
        self.progress = 0
        self.message = ""
        self.created_at = time.time()
        self.updated_at = self.created_at

    def to_dict(self) -> Dict[str, Any]:
        return {
            "task_id": self.task_id,
            "avatar_id": self.avatar_id,
            "status": self.status,
            "progress": self.progress,
            "message": self.message,
            "created_at": self.created_at,
            "updated_at": self.updated_at,
        }


def post_webhook(url: str, payload: Dict[str, Any]) -> None:
    """POST ``payload`` as JSON to ``url``; a failure is logged, never raised."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode("utf-8"),
                                 headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=WEBHOOK_TIMEOUT_S) as resp:
            resp.read()
    except Exception as e:
        logger.warning("task webhook failed: %s", e)


class TaskManager:
    def __init__(self, model_provider=None, device="cuda"):
        self.tasks: Dict[str, AvatarTask] = {}
        self._lock = threading.Lock()
        self._executor = ThreadPoolExecutor(max_workers=1)
        # callable returning the loaded model dict (for VAE params etc.)
        self.model_provider = model_provider
        self.device = str(device)

    def add_task(self, avatar_id: str, params: Dict[str, Any]) -> AvatarTask:
        resolve_device(self.device)
        task = AvatarTask(avatar_id, params)
        with self._lock:
            self.tasks[task.task_id] = task
        self._executor.submit(self._run_task, task)
        return task

    def get_task(self, task_id: str) -> Optional[AvatarTask]:
        return self.tasks.get(task_id)

    def list_tasks(self):
        return [t.to_dict() for t in self.tasks.values()]

    def delete_task(self, task_id: str) -> bool:
        with self._lock:
            return self.tasks.pop(task_id, None) is not None

    def _set(self, task: AvatarTask, status: Optional[str] = None,
             progress: Optional[int] = None, message: Optional[str] = None) -> None:
        if status:
            task.status = status
        if progress is not None:
            task.progress = progress
        if message is not None:
            task.message = message
        task.updated_at = time.time()
        self._notify(task)

    def _notify(self, task: AvatarTask) -> None:
        url = task.params.get("notifyurl")
        if url:
            post_webhook(url, task.to_dict())

    def _run_task(self, task: AvatarTask) -> None:
        from livetalking_tpu_torch.genavatar import (
            generate_ernerf_avatar,
            generate_musetalk_avatar,
            generate_ultralight_avatar,
            generate_wav2lip_avatar,
        )
        from livetalking_tpu_torch.genavatar.face import FaceDetector

        self._set(task, status="running", progress=1, message="started")
        try:
            params = task.params
            model_kind = params.get("model", "musetalk")
            video_path = params["video_path"]
            data_dir = params.get("data_dir", "./data")
            models_dir = params.get("models_dir", "./models")
            device = self.device

            def progress(pct: int, msg: str) -> None:
                self._set(task, progress=pct, message=msg)

            # detection backend per task (auto prefers s3fd weights and
            # refuses to fall back to center boxes on its own)
            detector = FaceDetector(kind=params.get("face_detector", "auto"),
                                    model_path=params.get("face_model"),
                                    models_dir=models_dir, device=device)
            common = dict(face_detector=detector, progress_callback=progress, device=device)
            if model_kind == "wav2lip":
                generate_wav2lip_avatar(video_path, task.avatar_id, data_dir,
                                        img_size=int(params.get("img_size", 256)),
                                        pads=tuple(params.get("pads", (0, 10, 0, 0))), **common)
            elif model_kind == "ultralight":
                generate_ultralight_avatar(video_path, task.avatar_id, data_dir,
                                           unet_checkpoint=params.get("unet_checkpoint"),
                                           models_dir=models_dir, **common)
            elif model_kind == "ernerf":
                generate_ernerf_avatar(video_path, task.avatar_id, data_dir,
                                       size=int(params.get("size", 64)),
                                       train_steps=int(params.get("train_steps", 200)),
                                       audio_path=params.get("audio_path"), **common)
            else:
                vae_params = None
                if self.model_provider is not None:
                    model = self.model_provider()
                    vae_params = model.get("vae_params") if model else None
                if vae_params is None:
                    from livetalking_tpu_torch.models import sd_vae

                    logger.warning("building musetalk avatar with random VAE weights")
                    vae_params = sd_vae.init_params(seed=0, device=device)
                generate_musetalk_avatar(video_path, task.avatar_id, data_dir,
                                         vae_params=vae_params,
                                         bbox_shift=int(params.get("bbox_shift", 0)),
                                         version=params.get("version", "v15"),
                                         models_dir=models_dir, **common)
            self._set(task, status="completed", progress=100, message="completed")
        except Exception as e:
            logger.exception("avatar task failed")
            self._set(task, status="failed", message=str(e))


task_manager = TaskManager()
