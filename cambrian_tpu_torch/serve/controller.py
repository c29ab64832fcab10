"""Serving controller: worker registry, heartbeat expiry, dispatch, and
stream proxying.

HTTP-protocol parity with the reference (serve/controller.py:246-289):
``/register_worker``, ``/refresh_all_workers``, ``/list_models``,
``/get_worker_address``, ``/receive_heart_beat``, ``/worker_generate_stream``
(proxied, \\0-framed JSON chunks), ``/worker_get_status`` — so existing
clients work unchanged. Built on stdlib ThreadingHTTPServer (the image has no
FastAPI); handlers are thread-per-request.

The port's copy of cambrian_tpu/serve/controller.py, which imports nothing
of the JAX package.
"""

import argparse
import dataclasses
import json
import threading
import time
from enum import Enum, auto
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

import numpy as np

from ..constants import CONTROLLER_HEART_BEAT_EXPIRATION
from ..utils import build_logger, server_error_msg

logger = None  # initialized in main()


class DispatchMethod(Enum):
    LOTTERY = auto()
    SHORTEST_QUEUE = auto()

    @classmethod
    def from_str(cls, name):
        if name == "lottery":
            return cls.LOTTERY
        if name == "shortest_queue":
            return cls.SHORTEST_QUEUE
        raise ValueError(f"Invalid dispatch method {name}")


@dataclasses.dataclass
class WorkerInfo:
    model_names: List[str]
    speed: int
    queue_length: int
    check_heart_beat: bool
    last_heart_beat: float


class Controller:
    """Worker registry with heartbeat expiry (controller.py:40-175)."""

    def __init__(self, dispatch_method: str = "shortest_queue"):
        self.worker_info: Dict[str, WorkerInfo] = {}
        self.dispatch_method = DispatchMethod.from_str(dispatch_method)
        self._lock = threading.Lock()
        self._hb_thread = threading.Thread(
            target=self._heart_beat_controller, daemon=True
        )
        self._hb_thread.start()

    def register_worker(self, worker_name: str, check_heart_beat: bool,
                        worker_status: dict) -> bool:
        if worker_status is None:
            worker_status = self.get_worker_status(worker_name)
        if not worker_status:
            return False
        with self._lock:
            self.worker_info[worker_name] = WorkerInfo(
                worker_status["model_names"], worker_status.get("speed", 1),
                worker_status.get("queue_length", 0), check_heart_beat, time.time(),
            )
        return True

    def get_worker_status(self, worker_name: str):
        import requests

        try:
            r = requests.post(worker_name + "/worker_get_status", timeout=5)
            return r.json()
        except Exception:
            return None

    def refresh_all_workers(self):
        with self._lock:
            old = dict(self.worker_info)
            self.worker_info = {}
        for name, info in old.items():
            if not self.register_worker(name, info.check_heart_beat, None):
                pass

    def list_models(self) -> List[str]:
        models = set()
        with self._lock:
            for info in self.worker_info.values():
                models.update(info.model_names)
        return sorted(models)

    def get_worker_address(self, model_name: str) -> str:
        with self._lock:
            candidates = [
                (name, info) for name, info in self.worker_info.items()
                if model_name in info.model_names
            ]
        if not candidates:
            return ""
        if self.dispatch_method == DispatchMethod.LOTTERY:
            speeds = np.array([i.speed for _, i in candidates], dtype=np.float64)
            total = speeds.sum()
            if total <= 0:
                return ""
            pick = np.random.choice(len(candidates), p=speeds / total)
            return candidates[pick][0]
        # shortest queue, normalized by speed (controller.py:154-172)
        qlens = [i.queue_length / max(i.speed, 1e-9) for _, i in candidates]
        idx = int(np.argmin(qlens))
        name = candidates[idx][0]
        with self._lock:
            if name in self.worker_info:
                self.worker_info[name].queue_length += 1
        return name

    def receive_heart_beat(self, worker_name: str, queue_length: int) -> bool:
        with self._lock:
            if worker_name not in self.worker_info:
                return False
            self.worker_info[worker_name].queue_length = queue_length
            self.worker_info[worker_name].last_heart_beat = time.time()
            return True

    def remove_stale_workers_by_expiration(self):
        expire = time.time() - CONTROLLER_HEART_BEAT_EXPIRATION
        to_delete = []
        with self._lock:
            for name, info in self.worker_info.items():
                if info.check_heart_beat and info.last_heart_beat < expire:
                    to_delete.append(name)
            for name in to_delete:
                del self.worker_info[name]

    def _heart_beat_controller(self):
        while True:
            time.sleep(CONTROLLER_HEART_BEAT_EXPIRATION)
            self.remove_stale_workers_by_expiration()

    def worker_api_generate_stream(self, params: dict):
        """Proxy streaming from the chosen worker (controller.py:197-219)."""
        import requests

        worker_addr = self.get_worker_address(params["model"])
        if not worker_addr:
            yield json.dumps({"text": server_error_msg, "error_code": 2}).encode() + b"\0"
            return
        try:
            response = requests.post(
                worker_addr + "/worker_generate_stream", json=params,
                stream=True, timeout=300,
            )
            for chunk in response.iter_lines(decode_unicode=False, delimiter=b"\0"):
                if chunk:
                    yield chunk + b"\0"
        except Exception:
            yield json.dumps({"text": server_error_msg, "error_code": 3}).encode() + b"\0"

    def worker_api_get_status(self):
        model_names = set()
        speed = 0
        queue_length = 0
        with self._lock:
            names = list(self.worker_info.keys())
        for name in names:
            status = self.get_worker_status(name)
            if status is not None:
                model_names.update(status["model_names"])
                speed += status.get("speed", 0)
                queue_length += status.get("queue_length", 0)
        return {"model_names": sorted(model_names), "speed": speed,
                "queue_length": queue_length}


def make_handler(controller: Controller):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):
            pass

        def _json(self):
            length = int(self.headers.get("Content-Length", 0))
            return json.loads(self.rfile.read(length) or b"{}")

        def _respond(self, obj, code=200):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_POST(self):
            data = self._json()
            if self.path == "/register_worker":
                ok = controller.register_worker(
                    data["worker_name"], data["check_heart_beat"],
                    data.get("worker_status"),
                )
                self._respond({}, 200 if ok else 400)
            elif self.path == "/refresh_all_workers":
                controller.refresh_all_workers()
                self._respond({})
            elif self.path == "/list_models":
                self._respond({"models": controller.list_models()})
            elif self.path == "/get_worker_address":
                self._respond({"address": controller.get_worker_address(data["model"])})
            elif self.path == "/receive_heart_beat":
                exist = controller.receive_heart_beat(
                    data["worker_name"], data["queue_length"])
                self._respond({"exist": exist})
            elif self.path == "/worker_get_status":
                self._respond(controller.worker_api_get_status())
            elif self.path == "/worker_generate_stream":
                self.send_response(200)
                self.send_header("Content-Type", "application/octet-stream")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                for chunk in controller.worker_api_generate_stream(data):
                    self.wfile.write(f"{len(chunk):x}\r\n".encode())
                    self.wfile.write(chunk + b"\r\n")
                self.wfile.write(b"0\r\n\r\n")
            else:
                self._respond({"error": "unknown endpoint"}, 404)

    return Handler


def serve(controller: Controller, host: str, port: int) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(controller))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def main():
    global logger
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21001)
    parser.add_argument("--dispatch-method", type=str,
                        choices=["lottery", "shortest_queue"],
                        default="shortest_queue")
    args = parser.parse_args()
    logger = build_logger("controller", "controller.log")
    controller = Controller(args.dispatch_method)
    logger.info("controller listening on %s:%d", args.host, args.port)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(controller))
    server.serve_forever()


if __name__ == "__main__":
    main()
