"""Gradio chat UI talking to the controller/worker tier
(reference serve/gradio_web_server.py).

gradio is an optional dependency (absent from the serving images); everything
gradio-specific is created inside ``build_demo``/``main`` so this module
stays importable for the HTTP helpers and logging either way.

The port's copy of cambrian_tpu/serve/gradio_web_server.py, which imports nothing
of the JAX package.
"""

import argparse
import datetime
import hashlib
import json
import os
import time

import requests

from ..constants import LOGDIR
from ..conversation import SeparatorStyle, conv_templates, default_conversation
from ..utils import build_logger, moderation_msg, server_error_msg, violates_moderation

logger = None

headers = {"User-Agent": "Cambrian-TPU Client"}

priority = {
    "cambrian-1": "aaaaaaa",
}


def get_conv_log_filename():
    t = datetime.datetime.now()
    return os.path.join(LOGDIR, f"{t.year}-{t.month:02d}-{t.day:02d}-conv.json")


def get_model_list(controller_url):
    ret = requests.post(controller_url + "/refresh_all_workers")
    assert ret.status_code == 200
    ret = requests.post(controller_url + "/list_models")
    models = ret.json()["models"]
    models.sort(key=lambda x: priority.get(x, x))
    return models


def save_image_if_new(image, t):
    """Log images by content hash (gradio_web_server.py:201-208)."""
    image_hash = hashlib.md5(image.tobytes()).hexdigest()
    filename = os.path.join(
        LOGDIR, "serve_images", f"{t.year}-{t.month:02d}-{t.day:02d}",
        f"{image_hash}.jpg",
    )
    if not os.path.isfile(filename):
        os.makedirs(os.path.dirname(filename), exist_ok=True)
        image.save(filename)
    return image_hash


def log_vote(vote_type: str, model_name: str, state: dict, ip: str = None):
    """Append an upvote/downvote/flag record to the conversation log
    (reference gradio_web_server.py:81-109 format: tstamp/type/model/state)."""
    record = {
        "tstamp": round(time.time(), 4),
        "type": vote_type,
        "model": model_name,
        "state": state,
    }
    if ip is not None:
        record["ip"] = ip
    with open(get_conv_log_filename(), "a") as f:
        f.write(json.dumps(record) + "\n")
    return record


def pop_last_exchange(chat_history):
    """Regenerate helper (gradio_web_server.py:111-118 semantics on our
    tuple-based history): drop the last assistant reply and return the
    (shortened history, last user message) so the UI can re-submit it."""
    if not chat_history:
        return chat_history, ""
    last_user, _last_reply = chat_history[-1]
    return chat_history[:-1], last_user


def select_conv_mode(model_name: str) -> str:
    """Per-model template map (gradio_web_server.py:164)."""
    lowered = model_name.lower()
    if "phi3" in lowered or "phi-3" in lowered:
        return "phi3"
    if "llama3" in lowered or "llama-3" in lowered:
        return "llama_3"
    if "34b" in lowered or "yi" in lowered:
        return "chatml_direct"
    return "vicuna_v1"


def http_bot_stream(controller_url, model_name, prompt, images_b64,
                    temperature, top_p, max_new_tokens, stop, conv_mode=""):
    """Query the controller for a worker and stream its reply
    (gradio_web_server.py:154-240). Yields cumulative text."""
    ret = requests.post(controller_url + "/get_worker_address",
                        json={"model": model_name})
    worker_addr = ret.json()["address"]
    if worker_addr == "":
        yield server_error_msg
        return
    pload = {
        "model": model_name,
        "prompt": prompt,
        "temperature": float(temperature),
        "top_p": float(top_p),
        "max_new_tokens": min(int(max_new_tokens), 1536),
        "stop": stop,
        "images": images_b64,
        "conv_mode": conv_mode,
    }
    try:
        response = requests.post(worker_addr + "/worker_generate_stream",
                                 headers=headers, json=pload, stream=True,
                                 timeout=300)
        for chunk in response.iter_lines(decode_unicode=False, delimiter=b"\0"):
            if chunk:
                data = json.loads(chunk.decode())
                if data["error_code"] == 0:
                    yield data["text"][len(prompt):].strip()
                else:
                    yield data["text"] + f" (error_code: {data['error_code']})"
                    return
    except requests.exceptions.RequestException:
        yield server_error_msg


def build_demo(embed_mode, controller_url, concurrency_count=16,
               moderate=False):
    """Gradio Blocks UI (gradio_web_server.py:311+)."""
    import gradio as gr

    models = get_model_list(controller_url)

    with gr.Blocks(title="Cambrian-TPU") as demo:
        state = gr.State()
        if not embed_mode:
            gr.Markdown("# Cambrian-TPU: vision-centric multimodal LLM")
        with gr.Row():
            with gr.Column(scale=3):
                model_selector = gr.Dropdown(choices=models,
                                             value=models[0] if models else "",
                                             label="Model")
                imagebox = gr.Image(type="pil", label="Image")
                temperature = gr.Slider(0.0, 1.0, value=0.2, step=0.1,
                                        label="Temperature")
                top_p = gr.Slider(0.0, 1.0, value=0.7, step=0.1, label="Top P")
                max_output_tokens = gr.Slider(0, 1024, value=512, step=64,
                                              label="Max output tokens")
            with gr.Column(scale=8):
                chatbot = gr.Chatbot(label="Cambrian Chatbot", height=550)
                textbox = gr.Textbox(show_label=False,
                                     placeholder="Enter text and press ENTER")
                submit_btn = gr.Button(value="Send")
                with gr.Row():
                    upvote_btn = gr.Button(value="👍 Upvote")
                    downvote_btn = gr.Button(value="👎 Downvote")
                    flag_btn = gr.Button(value="⚠️ Flag")
                    regenerate_btn = gr.Button(value="🔄 Regenerate")
                    clear_btn = gr.Button(value="🗑️ Clear")

        def respond(message, chat_history, image, model_name, temp, tp, mot):
            conv_mode = select_conv_mode(model_name)
            conv = conv_templates[conv_mode].copy()
            text = message
            images_b64 = []
            if image is not None:
                text = "<image>\n" + text
                if moderate and violates_moderation(text):
                    chat_history.append((message, moderation_msg))
                    return "", chat_history
                buffered_hash = save_image_if_new(image, datetime.datetime.now())
                import base64
                from io import BytesIO

                buf = BytesIO()
                image.save(buf, format="PNG")
                images_b64.append(base64.b64encode(buf.getvalue()).decode())
            conv.append_message(conv.roles[0], text)
            conv.append_message(conv.roles[1], None)
            prompt = conv.get_prompt()
            stop = conv.sep if conv.sep_style in (
                SeparatorStyle.SINGLE, SeparatorStyle.MPT) else conv.sep2
            reply = ""
            for reply in http_bot_stream(controller_url, model_name, prompt,
                                         images_b64, temp, tp, mot, stop,
                                         conv_mode):
                pass
            chat_history.append((message, reply))
            with open(get_conv_log_filename(), "a") as f:
                f.write(json.dumps({
                    "tstamp": round(time.time(), 4), "type": "chat",
                    "model": model_name, "state": {"prompt": prompt, "reply": reply},
                }) + "\n")
            return "", chat_history

        def vote(vote_type, chat_history, model_name):
            if chat_history:
                log_vote(vote_type, model_name,
                         {"history": chat_history[-1:]})
            return chat_history

        def on_regenerate(chat_history, image, model_name, temp, tp, mot):
            history, last_user = pop_last_exchange(chat_history)
            if not last_user:
                return "", history
            return respond(last_user, history, image, model_name, temp, tp,
                           mot)

        inputs = [textbox, chatbot, imagebox, model_selector, temperature,
                  top_p, max_output_tokens]
        textbox.submit(respond, inputs, [textbox, chatbot])
        submit_btn.click(respond, inputs, [textbox, chatbot])
        upvote_btn.click(lambda h, m: vote("upvote", h, m),
                         [chatbot, model_selector], [chatbot])
        downvote_btn.click(lambda h, m: vote("downvote", h, m),
                           [chatbot, model_selector], [chatbot])
        flag_btn.click(lambda h, m: vote("flag", h, m),
                       [chatbot, model_selector], [chatbot])
        regenerate_btn.click(on_regenerate, inputs[1:], [textbox, chatbot])
        clear_btn.click(lambda: ("", []), [], [textbox, chatbot])
    return demo


def main():
    global logger
    parser = argparse.ArgumentParser()
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=7860)
    parser.add_argument("--controller-url", type=str,
                        default="http://localhost:21001")
    parser.add_argument("--concurrency-count", type=int, default=16)
    parser.add_argument("--share", action="store_true")
    parser.add_argument("--moderate", action="store_true")
    parser.add_argument("--embed", action="store_true")
    args = parser.parse_args()
    logger = build_logger("gradio_web_server", "gradio_web_server.log")
    try:
        import gradio  # noqa: F401
    except ImportError as e:
        raise SystemExit(
            "gradio is not installed in this image; the controller/worker "
            "HTTP tier and serve/cli.py work without it"
        ) from e
    demo = build_demo(args.embed, args.controller_url, args.concurrency_count,
                      args.moderate)
    demo.queue().launch(server_name=args.host, server_port=args.port,
                        share=args.share)


if __name__ == "__main__":
    main()
