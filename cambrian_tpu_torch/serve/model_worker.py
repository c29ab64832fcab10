"""Model worker: loads a checkpoint and streams generations
(cambrian_tpu/serve/model_worker.py).

HTTP-protocol parity with the reference (serve/model_worker.py:234-247):
``/worker_generate_stream`` (cumulative-text \\0-framed JSON chunks) and
``/worker_get_status``; heartbeat thread registering with the controller
every WORKER_HEART_BEAT_INTERVAL seconds (model_worker.py:39-43, 89-108).
Concurrency is bounded by a semaphore (model_worker.py:240-247).

``--device`` is ``cuda`` by default; asking for it without a card raises,
nothing falls back to the CPU. ``--device cpu`` runs fp32, as
``serve/cli.py`` does. ``--continuous-batching`` serves concurrent requests
through one ``ContinuousBatchingEngine``, driven by a stepper thread that
``close()`` stops.

    python -m cambrian_tpu_torch.serve.controller
    python -m cambrian_tpu_torch.serve.model_worker --model-path DIR \\
        --continuous-batching --device cuda
"""

import argparse
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from ..constants import WORKER_HEART_BEAT_INTERVAL
from ..mm_utils import (
    get_model_name_from_path,
    load_image_from_base64,
    process_images,
    tokenizer_image_token,
    tokenizer_image_token_llama3,
)
from ..utils import build_logger, server_error_msg

GB = 1 << 30


class ModelWorker:
    def __init__(self, controller_addr: str, worker_addr: str, worker_id: str,
                 model_path: str, model_base: Optional[str], model_name: Optional[str],
                 load_8bit=False, load_4bit=False, device="cuda",
                 limit_model_concurrency: int = 5, register: bool = True,
                 model_bundle=None, continuous_batching: bool = False,
                 num_slots: int = 4, cb_chunk: int = 8):
        from ..models.builder import load_pretrained_model

        if str(device).startswith("cuda") and not torch.cuda.is_available():
            raise RuntimeError(f"no CUDA device for a worker on {device}")
        self.controller_addr = controller_addr
        self.worker_addr = worker_addr
        self.worker_id = worker_id
        self.model_name = model_name or get_model_name_from_path(model_path)
        self.device = device
        self.semaphore = threading.Semaphore(limit_model_concurrency)
        self.limit_model_concurrency = limit_model_concurrency
        self.global_counter = 0

        if model_bundle is not None:
            (self.tokenizer, self.model, self.image_processor,
             self.context_len) = model_bundle
        else:
            (self.tokenizer, self.model, self.image_processor,
             self.context_len) = load_pretrained_model(
                model_path, model_base, self.model_name, load_8bit, load_4bit,
                device=device, dtype=torch.float32 if device == "cpu" else torch.bfloat16,
            )
        self.is_multimodal = "cambrian" in self.model_name.lower() or True

        # continuous batching: concurrent requests share one KV cache and
        # advance in lockstep; a single stepper thread drives the engine while
        # request threads stream tokens out
        self.cb_engine = None
        self.cb_chunk = max(1, int(cb_chunk))
        self._cb_stop = threading.Event()
        self._cb_thread = None
        if continuous_batching:
            from ..infer.continuous import ContinuousBatchingEngine

            self.cb_engine = ContinuousBatchingEngine(
                self.model.lm, num_slots=num_slots, max_len=self.context_len + 1024,
                device=device)
            self._cb_wake = threading.Event()
            self._cb_thread = threading.Thread(target=self._cb_stepper, daemon=True)
            self._cb_thread.start()

        if register:
            self.register_to_controller()
            self._hb = threading.Thread(target=self._heart_beat_worker, daemon=True)
            self._hb.start()

    def _cb_stepper(self):
        while not self._cb_stop.is_set():
            # chunked lockstep decode: all slots advance cb_chunk tokens a step
            # (admission happens at chunk boundaries)
            active = self.cb_engine.step_chunk(self.cb_chunk) \
                if self.cb_chunk > 1 else self.cb_engine.step()
            if active == 0 and self.cb_engine._pending.empty():
                self._cb_wake.wait(timeout=0.05)
                self._cb_wake.clear()

    def close(self):
        """Stop the continuous-batching stepper thread (after its step)."""
        self._cb_stop.set()
        if self._cb_thread is not None:
            self._cb_wake.set()
            self._cb_thread.join()

    # -- controller plumbing -------------------------------------------------

    def register_to_controller(self):
        import requests

        url = self.controller_addr + "/register_worker"
        data = {
            "worker_name": self.worker_addr,
            "check_heart_beat": True,
            "worker_status": self.get_status(),
        }
        r = requests.post(url, json=data, timeout=5)
        assert r.status_code == 200, r.text

    def _heart_beat_worker(self):
        import requests

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
        return {
            "model_names": [self.model_name],
            "speed": 1,
            "queue_length": self.get_queue_length(),
        }

    # -- generation ------------------------------------------------------------

    def generate_stream(self, params: dict):
        """Yields \\0-framed JSON chunks with cumulative text
        (model_worker.py:124-196 semantics)."""
        tokenizer, model = self.tokenizer, self.model
        prompt = params["prompt"]
        ori_prompt = prompt
        images = params.get("images", None)
        image_sizes = None
        image_tensor = None

        if images is not None and len(images) > 0 and self.is_multimodal:
            if prompt.count("<image>") != len(images):
                raise ValueError(
                    "Number of images does not match number of <image> tokens")
            pil_images = [load_image_from_base64(im) for im in images]
            image_sizes = [im.size for im in pil_images]
            image_tensor = process_images(pil_images, self.image_processor,
                                          model.config)

        temperature = float(params.get("temperature", 1.0))
        top_p = float(params.get("top_p", 1.0))
        max_new_tokens = min(int(params.get("max_new_tokens", 256)), 1024)
        stop_str = params.get("stop", None)
        do_sample = temperature > 0.001

        tok_fn = (tokenizer_image_token_llama3
                  if "llama_3" in params.get("conv_mode", "") else
                  tokenizer_image_token)
        input_ids = np.asarray(tok_fn(prompt, tokenizer), dtype=np.int64)

        if max_new_tokens < 1:
            yield json.dumps({
                "text": ori_prompt + "Exceeds max token length. Please start a new conversation, thanks.",
                "error_code": 0,
            }).encode() + b"\0"
            return

        if self.cb_engine is not None:
            yield from self._generate_stream_cb(
                ori_prompt, input_ids, image_tensor, image_sizes,
                do_sample, temperature, top_p, max_new_tokens, stop_str)
            return

        generated_text = ori_prompt
        for out_ids in model.generate_stream(
            input_ids, images=image_tensor, image_sizes=image_sizes,
            do_sample=do_sample, temperature=temperature, top_p=top_p,
            max_new_tokens=max_new_tokens,
            # decode steps between yields (clients may lower it for smoother UX)
            stream_chunk=int(params.get("stream_chunk", 8)),
        ):
            text = tokenizer.decode(out_ids[0], skip_special_tokens=True)
            if stop_str and stop_str in text:
                text = text[: text.index(stop_str)]
                generated_text = ori_prompt + text
                yield json.dumps({"text": generated_text, "error_code": 0}
                                 ).encode() + b"\0"
                return
            generated_text = ori_prompt + text
            yield json.dumps({"text": generated_text, "error_code": 0}
                             ).encode() + b"\0"

    def _generate_stream_cb(self, ori_prompt, input_ids, image_tensor,
                            image_sizes, do_sample, temperature, top_p,
                            max_new_tokens, stop_str):
        """Continuous-batching path: submit into the shared engine and stream
        tokens as its stepper thread produces them."""
        import queue as _q

        from ..infer.engine import GenerationConfig

        pids, pmask, ppos, feats, aux_masks, _, _ = self.model._prepare_generate(
            input_ids, images=image_tensor, image_sizes=image_sizes,
            max_new_tokens=max_new_tokens,
        )
        cfg = GenerationConfig(
            max_new_tokens=max_new_tokens,
            temperature=temperature if do_sample else 0.0,
            top_p=top_p,
            eos_token_id=getattr(self.tokenizer, "eos_token_id", None),
        )
        token_queue: "_q.Queue" = _q.Queue()
        req = self.cb_engine.submit(pids[0], pmask[0], ppos[0], feats,
                                    aux_masks, cfg,
                                    on_token=token_queue.put)
        self._cb_wake.set()

        tokens = []
        while True:
            try:
                tokens.append(token_queue.get(timeout=120))
            except _q.Empty:
                yield json.dumps({"text": server_error_msg, "error_code": 1}
                                 ).encode() + b"\0"
                return
            text = self.tokenizer.decode(tokens, skip_special_tokens=True)
            if stop_str and stop_str in text:
                text = text[: text.index(stop_str)]
                yield json.dumps({"text": ori_prompt + text, "error_code": 0}
                                 ).encode() + b"\0"
                return
            yield json.dumps({"text": ori_prompt + text, "error_code": 0}
                             ).encode() + b"\0"
            if req.finished and token_queue.empty():
                return

    def generate_stream_gate(self, params):
        try:
            yield from self.generate_stream(params)
        except Exception as e:
            yield json.dumps({"text": f"{server_error_msg}\n\n({e})",
                              "error_code": 1}).encode() + b"\0"


def make_handler(worker: ModelWorker):
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
            if self.path == "/worker_get_status":
                self._respond(worker.get_status())
            elif self.path == "/worker_generate_stream":
                worker.semaphore.acquire()
                worker.global_counter += 1
                try:
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Transfer-Encoding", "chunked")
                    self.end_headers()
                    for chunk in worker.generate_stream_gate(data):
                        self.wfile.write(f"{len(chunk):x}\r\n".encode())
                        self.wfile.write(chunk + b"\r\n")
                    self.wfile.write(b"0\r\n\r\n")
                finally:
                    worker.semaphore.release()
            else:
                self._respond({"error": "unknown endpoint"}, 404)

    return Handler


def serve(worker: ModelWorker, host: str, port: int) -> ThreadingHTTPServer:
    server = ThreadingHTTPServer((host, port), make_handler(worker))
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=int, default=21002)
    parser.add_argument("--worker-address", type=str,
                        default="http://localhost:21002")
    parser.add_argument("--controller-address", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--model-path", type=str, required=True)
    parser.add_argument("--model-base", type=str, default=None)
    parser.add_argument("--model-name", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--limit-model-concurrency", type=int, default=5)
    parser.add_argument("--no-register", action="store_true")
    parser.add_argument("--cb-chunk", type=int, default=8,
                        help="tokens decoded a step in continuous-batching mode")
    parser.add_argument("--continuous-batching", action="store_true",
                        help="serve concurrent requests through one shared "
                        "KV cache (slot-based continuous batching)")
    parser.add_argument("--num-slots", type=int, default=4)
    args = parser.parse_args()

    logger = build_logger("model_worker", f"model_worker_{uuid.uuid4().hex[:6]}.log")
    worker = ModelWorker(
        args.controller_address, args.worker_address, uuid.uuid4().hex[:6],
        args.model_path, args.model_base, args.model_name,
        device=args.device, limit_model_concurrency=args.limit_model_concurrency,
        register=not args.no_register,
        continuous_batching=args.continuous_batching, num_slots=args.num_slots,
        cb_chunk=args.cb_chunk,
    )
    logger.info("worker listening on %s:%d", args.host, args.port)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(worker))
    server.serve_forever()


if __name__ == "__main__":
    main()
