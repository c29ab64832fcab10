"""Forwarding worker: exposes the standard worker API but proxies generation
to a remote inference endpoint (the reference's sglang_worker.py:132-171 fills
this role by forwarding to an SGLang server; ours forwards to any endpoint
speaking a simple JSON protocol, e.g. another Cambrian worker or an
OpenAI-compatible completions server).

The port's copy of cambrian_tpu/serve/remote_worker.py, which imports nothing
of the JAX package.
"""

import argparse
import json
import threading
import time
import uuid
from http.server import ThreadingHTTPServer

import requests

from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..utils import build_logger, server_error_msg
from .model_worker import make_handler


class RemoteWorker:
    """Same surface as ModelWorker but generation goes over HTTP."""

    def __init__(self, controller_addr: str, worker_addr: str,
                 backend_url: str, model_name: str,
                 limit_model_concurrency: int = 5, register: bool = True):
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.backend_url = backend_url
        self.model_name = model_name
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self.limit_model_concurrency = limit_model_concurrency
        self.global_counter = 0
        if register:
            self.register_to_controller()
            threading.Thread(target=self._heart_beat_worker, daemon=True).start()

    def register_to_controller(self):
        r = requests.post(
            self.controller_addr + "/register_worker",
            json={"worker_name": self.worker_addr, "check_heart_beat": True,
                  "worker_status": self.get_status()},
            timeout=5,
        )
        assert r.status_code == 200, r.text

    def _heart_beat_worker(self):
        while True:
            time.sleep(WORKER_HEART_BEAT_INTERVAL)
            try:
                r = requests.post(
                    self.controller_addr + "/receive_heart_beat",
                    json={"worker_name": self.worker_addr,
                          "queue_length": self.get_queue_length()},
                    timeout=5,
                )
                if not r.json().get("exist", False):
                    self.register_to_controller()
            except Exception:
                pass

    def get_queue_length(self):
        return self.limit_model_concurrency - self.semaphore._value

    def get_status(self):
        return {"model_names": [self.model_name], "speed": 1,
                "queue_length": self.get_queue_length()}

    def generate_stream_gate(self, params):
        try:
            response = requests.post(
                self.backend_url + "/worker_generate_stream", json=params,
                stream=True, timeout=300,
            )
            for chunk in response.iter_lines(decode_unicode=False, delimiter=b"\0"):
                if chunk:
                    yield chunk + b"\0"
        except Exception as e:
            yield json.dumps({"text": f"{server_error_msg}\n\n({e})",
                              "error_code": 1}).encode() + b"\0"


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21003)
    parser.add_argument("--worker-address", type=str,
                        default="http://localhost:21003")
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--backend-url", type=str, required=True)
    parser.add_argument("--model-name", type=str, required=True)
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    args = parser.parse_args()

    build_logger("remote_worker", f"remote_worker_{uuid.uuid4().hex[:6]}.log")
    worker = RemoteWorker(
        args.controller_address, args.worker_address, args.backend_url,
        args.model_name, args.limit_model_concurrency,
        register=not args.no_register,
    )
    server = ThreadingHTTPServer((args.host, args.port), make_handler(worker))
    server.serve_forever()


if __name__ == "__main__":
    main()
