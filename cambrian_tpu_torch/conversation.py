"""Conversation/prompt templates.

Re-implements the prompt-assembly semantics of the reference
(cambrian/conversation.py:9-176 for the separator styles,
:280-596 for the per-model templates). Byte-exact prompt strings are required
for checkpoint parity, so each style's formatter reproduces the reference's
concatenation order, including its quirks (e.g. LLAMA_3 always appends the
trailing assistant header; LLAMA_2/MISTRAL lstrip the leading sep).

The image-bearing message convention is the same: a message may be a tuple
``(text, image, image_process_mode)``; ``get_prompt`` folds the image into the
first message as ``"<image>\n" + text`` (or ``<Image><image></Image>`` turns
for the *mmtag* variants).
"""

import base64
import dataclasses
from enum import Enum, auto
from io import BytesIO
from typing import Any, List, Optional, Sequence, Tuple


class SeparatorStyle(Enum):
    SINGLE = auto()
    TWO = auto()
    MPT = auto()
    PLAIN = auto()
    LLAMA_2 = auto()
    LLAMA_3 = auto()
    MISTRAL = auto()
    GEMMA = auto()
    PHI3 = auto()


def _msg_text(message: Any) -> str:
    """Messages holding images are (text, image, mode) tuples."""
    if isinstance(message, tuple):
        return message[0]
    return message


@dataclasses.dataclass
class Conversation:
    """Rolling conversation state plus a prompt renderer."""

    system: str
    roles: Tuple[str, str]
    messages: List[List[Any]]
    offset: int
    sep_style: SeparatorStyle = SeparatorStyle.SINGLE
    sep: str = "###"
    sep2: Optional[str] = None
    version: str = "Unknown"
    skip_next: bool = False

    def get_prompt(self) -> str:
        messages = self.messages
        # Fold a leading image tuple into the first user turn.
        if len(messages) > 0 and isinstance(messages[0][1], tuple):
            messages = [list(m) for m in self.messages]
            init_role, init_msg = messages[0]
            init_text = init_msg[0].replace("<image>", "").strip()
            if "mmtag" in self.version:
                messages[0] = [init_role, init_text]
                messages.insert(0, [self.roles[0], "<Image><image></Image>"])
                messages.insert(1, [self.roles[1], "Received."])
            else:
                messages[0] = [init_role, "<image>\n" + init_text]

        style = self.sep_style
        if style == SeparatorStyle.SINGLE:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + ": " + _msg_text(message) + self.sep
                else:
                    ret += role + ":"
            return ret

        if style == SeparatorStyle.TWO:
            seps = [self.sep, self.sep2]
            ret = self.system + seps[0]
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += role + ": " + _msg_text(message) + seps[i % 2]
                else:
                    ret += role + ":"
            return ret

        if style == SeparatorStyle.MPT:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + _msg_text(message) + self.sep
                else:
                    ret += role
            return ret

        if style in (SeparatorStyle.LLAMA_2, SeparatorStyle.MISTRAL):
            def wrap_sys(msg):
                return f"<<SYS>>\n{msg}\n<</SYS>>\n\n" if len(msg) > 0 else msg

            def wrap_inst(msg):
                return f"[INST] {msg} [/INST]"

            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message should come from user"
                if message:
                    text = _msg_text(message)
                    if i == 0:
                        text = wrap_sys(self.system) + text
                    if i % 2 == 0:
                        ret += self.sep + wrap_inst(text)
                    elif style == SeparatorStyle.LLAMA_2:
                        ret += " " + text + " " + self.sep2
                    else:  # MISTRAL: no surrounding spaces on replies
                        ret += text + self.sep2
            return ret.lstrip(self.sep) if self.sep else ret

        if style == SeparatorStyle.LLAMA_3:
            ret = ""
            for i, (role, message) in enumerate(messages):
                if i == 0:
                    assert message, "first message should not be none"
                    assert role == self.roles[0], "first message should come from user"
                if message:
                    text = _msg_text(message)
                    if i == 0 and len(self.system) > 0:
                        ret += (
                            "<|begin_of_text|><|start_header_id|>system"
                            f"<|end_header_id|>{self.system}<|eot_id|>"
                        )
                    header = "user" if i % 2 == 0 else "assistant"
                    ret += f"<|start_header_id|>{header}<|end_header_id|>{text}<|eot_id|>"
            ret += "<|start_header_id|>assistant<|end_header_id|>"
            return ret

        if style == SeparatorStyle.PLAIN:
            seps = [self.sep, self.sep2]
            ret = self.system
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += _msg_text(message) + seps[i % 2]
            return ret

        if style == SeparatorStyle.GEMMA:
            ret = self.system + self.sep
            for role, message in messages:
                if message:
                    ret += role + _msg_text(message) + self.sep
                else:
                    ret += role
            return ret

        if style == SeparatorStyle.PHI3:
            ret = self.system + self.sep
            for i, (role, message) in enumerate(messages):
                if message:
                    ret += self.roles[i % 2] + _msg_text(message) + self.sep
                else:
                    ret += self.roles[i % 2]
            return ret

        raise ValueError(f"Invalid style: {self.sep_style}")

    def append_message(self, role: str, message: Any) -> None:
        self.messages.append([role, message])

    def process_image(self, image, image_process_mode, return_pil=False,
                      image_format="PNG", max_len=1344, min_len=672):
        """Serving-path image normalization (conversation.py:181-219)."""
        from PIL import Image

        if image_process_mode == "Pad":
            from .mm_utils import expand2square
            image = expand2square(image, (122, 116, 104))
        elif image_process_mode in ("Default", "Crop"):
            pass
        elif image_process_mode == "Resize":
            image = image.resize((336, 336))
        else:
            raise ValueError(f"Invalid image_process_mode: {image_process_mode}")

        if max(image.size) > max_len:
            max_hw, min_hw = max(image.size), min(image.size)
            aspect_ratio = max_hw / min_hw
            shortest_edge = int(min(max_len / aspect_ratio, min_len, min_hw))
            longest_edge = int(shortest_edge * aspect_ratio)
            w, h = image.size
            if h > w:
                h, w = longest_edge, shortest_edge
            else:
                h, w = shortest_edge, longest_edge
            image = image.resize((w, h))
        if return_pil:
            return image
        buffered = BytesIO()
        image.save(buffered, format=image_format)
        return base64.b64encode(buffered.getvalue()).decode()

    def get_images(self, return_pil=False):
        images = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0 and isinstance(msg, tuple):
                text, image, image_process_mode = msg
                images.append(self.process_image(image, image_process_mode, return_pil=return_pil))
        return images

    def to_gradio_chatbot(self):
        ret = []
        for i, (role, msg) in enumerate(self.messages[self.offset:]):
            if i % 2 == 0:
                if isinstance(msg, tuple):
                    text, image, _mode = msg
                    img_b64 = self.process_image(image, "Default", return_pil=False, image_format="JPEG")
                    img_str = f'<img src="data:image/jpeg;base64,{img_b64}" alt="user upload image" />'
                    ret.append([img_str + text.replace("<image>", "").strip(), None])
                else:
                    ret.append([msg, None])
            else:
                ret[-1][-1] = msg
        return ret

    def copy(self) -> "Conversation":
        return Conversation(
            system=self.system,
            roles=self.roles,
            messages=[[x, y] for x, y in self.messages],
            offset=self.offset,
            sep_style=self.sep_style,
            sep=self.sep,
            sep2=self.sep2,
            version=self.version,
        )

    def dict(self):
        if len(self.get_images()) > 0:
            messages = [[x, y[0] if isinstance(y, tuple) else y] for x, y in self.messages]
        else:
            messages = self.messages
        return {
            "system": self.system,
            "roles": self.roles,
            "messages": messages,
            "offset": self.offset,
            "sep": self.sep,
            "sep2": self.sep2,
        }


def _conv(**kwargs) -> Conversation:
    kwargs.setdefault("messages", [])
    kwargs.setdefault("offset", 0)
    return Conversation(**kwargs)


conv_vicuna_v0 = _conv(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    # Few-shot seed exchange baked into the v0 template (conversation.py:284-305).
    messages=[
        ["Human", "What are the key differences between renewable and non-renewable energy sources?"],
        ["Assistant",
         "Renewable energy sources are those that can be replenished naturally in a relatively "
         "short amount of time, such as solar, wind, hydro, geothermal, and biomass. "
         "Non-renewable energy sources, on the other hand, are finite and will eventually be "
         "depleted, such as coal, oil, and natural gas. Here are some key differences between "
         "renewable and non-renewable energy sources:\n"
         "1. Availability: Renewable energy sources are virtually inexhaustible, while non-renewable "
         "energy sources are finite and will eventually run out.\n"
         "2. Environmental impact: Renewable energy sources have a much lower environmental impact "
         "than non-renewable sources, which can lead to air and water pollution, greenhouse gas emissions, "
         "and other negative effects.\n"
         "3. Cost: Renewable energy sources can be more expensive to initially set up, but they typically "
         "have lower operational costs than non-renewable sources.\n"
         "4. Reliability: Renewable energy sources are often more reliable and can be used in more remote "
         "locations than non-renewable sources.\n"
         "5. Flexibility: Renewable energy sources are often more flexible and can be adapted to different "
         "situations and needs, while non-renewable sources are more rigid and inflexible.\n"
         "6. Sustainability: Renewable energy sources are more sustainable over the long term, while "
         "non-renewable sources are not, and their depletion can lead to economic and social instability.\n"],
    ],
    offset=2,
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_vicuna_v1 = _conv(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the user's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_vicuna_cambrian = _conv(
    system="",
    roles=("Human", "GPT"),
    version="vicuna_cambrian",
    sep_style=SeparatorStyle.TWO,
    sep="\n",
    sep2="\n\n",
)

conv_llama_2 = _conv(
    system=(
        "You are a helpful, respectful and honest assistant. Always answer as helpfully "
        "as possible, while being safe.  Your answers should not include any harmful, "
        "unethical, racist, sexist, toxic, dangerous, or illegal content. Please ensure "
        "that your responses are socially unbiased and positive in nature.\n\n"
        "If a question does not make any sense, or is not factually coherent, explain why "
        "instead of answering something not correct. If you don't know the answer to a "
        "question, please don't share false information."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_cambrian_llama_2 = _conv(
    system=(
        "You are a helpful language and vision assistant. "
        "You are able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="<s>",
    sep2="</s>",
)

conv_mpt = _conv(
    system=(
        "<|im_start|>system\nA conversation between a user and an LLM-based AI assistant. "
        "The assistant gives helpful and honest answers."
    ),
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_gemma = _conv(
    system="",
    roles=("<start_of_turn>user\n", "<start_of_turn>model\n"),
    version="gemma",
    sep_style=SeparatorStyle.GEMMA,
    sep="<end_of_turn>\n",
)

conv_cambrian_plain = _conv(
    system="",
    roles=("", ""),
    sep_style=SeparatorStyle.PLAIN,
    sep="\n",
)

conv_cambrian_v0 = _conv(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
)

conv_cambrian_v0_mmtag = _conv(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant is able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
        "The visual content will be provided with the following format: "
        "<Image>visual content</Image>."
    ),
    roles=("Human", "Assistant"),
    sep_style=SeparatorStyle.SINGLE,
    sep="###",
    version="v0_mmtag",
)

conv_cambrian_v1 = _conv(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="v1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
)

conv_cambrian_cohere = _conv(
    system=(
        "A chat between a curious human and an artificial intelligence assistant. "
        "The assistant gives helpful, detailed, and polite answers to the human's questions."
    ),
    roles=("USER", "ASSISTANT"),
    version="coherev1",
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="<|END_OF_TURN_TOKEN|>",
)

conv_cambrian_v1_mmtag = _conv(
    system=(
        "A chat between a curious user and an artificial intelligence assistant. "
        "The assistant is able to understand the visual content that the user provides, "
        "and assist the user with a variety of tasks using natural language."
        "The visual content will be provided with the following format: "
        "<Image>visual content</Image>."
    ),
    roles=("USER", "ASSISTANT"),
    sep_style=SeparatorStyle.TWO,
    sep=" ",
    sep2="</s>",
    version="v1_mmtag",
)

conv_mistral_instruct = _conv(
    system="",
    roles=("USER", "ASSISTANT"),
    version="llama_v2",
    sep_style=SeparatorStyle.LLAMA_2,
    sep="",
    sep2="</s>",
)

conv_mistral_v2 = _conv(
    system="",
    roles=("USER", "ASSISTANT"),
    version="mistral_v2",
    sep_style=SeparatorStyle.MISTRAL,
    sep="",
    sep2="</s>",
)

conv_llama_3 = _conv(
    system=(
        "You are Cambrian, a highly intelligent multimodal AI trained by NYU Vision X. \n"
        "    As a multimodal AI, you have the ability to process and analyze images. "
        "Whenever an image is present in the conversation, very carefully examine it and "
        "consider its content when formulating your response.\n"
        "    You should give concise responses to very simple questions, but provide "
        "thorough responses to more complex and open-ended questions. "
    ),
    roles=("USER", "ASSISTANT"),
    version="llama_v3",
    sep_style=SeparatorStyle.LLAMA_3,
    sep="<|begin_of_text|>",
    sep2="<|end_of_text|>",
)

_CAMBRIAN_CHATML_SYSTEM = (
    "<|im_start|>system\nYou are Cambrian, a highly intelligent multimodal AI trained by "
    "NYU Vision X. As a multimodal AI, you have the ability to process and analyze images. "
    "Whenever an image is present in the conversation, very carefully examine it and "
    "consider its content when formulating your response. You should give concise "
    "responses to very simple questions, but provide thorough responses to more complex "
    "and open-ended questions."
)

conv_chatml_direct = _conv(
    system=_CAMBRIAN_CHATML_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_cambrian_chatml = _conv(
    system=_CAMBRIAN_CHATML_SYSTEM,
    roles=("<|im_start|>user\n", "<|im_start|>assistant\n"),
    version="mpt",
    sep_style=SeparatorStyle.MPT,
    sep="<|im_end|>",
)

conv_phi3 = _conv(
    system="<|system|>\nYou are a helpful AI assistant.",
    roles=("\n<|user|>\n", "\n<|assistant|>\n"),
    version="phi3",
    sep_style=SeparatorStyle.PHI3,
    sep="<|end|>",
)

default_conversation = conv_vicuna_v1

conv_templates = {
    "default": conv_vicuna_v0,
    "v0": conv_vicuna_v0,
    "v1": conv_vicuna_v1,
    "vicuna_v1": conv_vicuna_v1,
    "vicuna_cambrian": conv_vicuna_cambrian,
    "cohere_v1": conv_cambrian_cohere,
    "llama_2": conv_llama_2,
    "llama_3": conv_llama_3,
    "llama_v3": conv_llama_3,
    "mistral_instruct": conv_mistral_instruct,
    "chatml_direct": conv_chatml_direct,
    "cambrian_chatml": conv_cambrian_chatml,
    "mistral_direct": conv_chatml_direct,
    "mistral_v2": conv_mistral_v2,
    "plain": conv_cambrian_plain,
    "v0_plain": conv_cambrian_plain,
    "cambrian_v0": conv_cambrian_v0,
    "v0_mmtag": conv_cambrian_v0_mmtag,
    "cambrian_v1": conv_cambrian_v1,
    "v1_mmtag": conv_cambrian_v1_mmtag,
    "cambrian_llama_2": conv_cambrian_llama_2,
    "mpt": conv_mpt,
    "conv_gemma": conv_gemma,
    "phi3": conv_phi3,
}
