"""Self-describing model configuration.

One config object covers the decoder family (LLaMA-3 / Vicuna / Yi share the
llama architecture; Phi-3 / Mistral / Gemma / Cohere differ in a few switches)
plus every SVA/multimodal hyperparameter the reference persists into its HF
config (cambrian_arch.py:113-121, train_fsdp.py:83-107), so checkpoints are
self-describing and interchangeable.
"""

import dataclasses
import json
from dataclasses import dataclass, field
from typing import List, Optional, Tuple


@dataclass
class CambrianConfig:
    # ----- decoder architecture -----
    model_type: str = "llama"          # llama | phi3 | mistral | gemma | cohere
    vocab_size: int = 128256
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 8
    head_dim: Optional[int] = None     # defaults to hidden_size // num_attention_heads
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    max_position_embeddings: int = 8192
    original_max_position_embeddings: Optional[int] = None  # phi3 longrope
    rope_scaling: Optional[dict] = None
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    hidden_act: str = "silu"
    sliding_window: Optional[int] = None  # mistral/phi3
    logit_scale: Optional[float] = None   # cohere
    use_qk_norm: bool = False             # cohere variants
    attn_logit_softcapping: Optional[float] = None   # gemma2 (50.0)
    final_logit_softcapping: Optional[float] = None  # gemma2 (30.0)
    bos_token_id: int = 128000
    eos_token_id: int = 128001
    pad_token_id: Optional[int] = None

    # ----- multimodal / SVA -----
    mm_projector_type: str = "sva"     # sva | linear | mlp{N}x_gelu | se_mlp | identity
    mm_hidden_size: Optional[int] = None  # for non-sva projectors: sum of tower dims
    vision_hidden_size: int = 1024
    num_query_group: int = 1
    query_num_list: Tuple[int, ...] = (576,)
    connector_depth: int = 3
    connector_only: bool = False
    num_of_vision_sampler_layers: int = 10
    start_of_vision_sampler_layers: int = 0
    stride_of_vision_sampler_layers: int = 3
    image_token_len: int = 576
    image_position: int = 91
    mm_vision_tower_aux_list: Tuple[str, ...] = (
        "siglip/CLIP-ViT-SO400M-14-384",
        "openai/clip-vit-large-patch14-336",
        "facebook/dinov2-giant-res378",
        "clip-convnext-XXL-multi-stage",
    )
    mm_vision_tower_aux_token_len_list: Tuple[int, ...] = (576, 576, 576, 9216)
    mm_vision_select_layer: int = -2
    mm_vision_select_feature: str = "patch"
    mm_use_im_start_end: bool = False
    mm_use_im_patch_token: bool = False
    tokenizer_model_max_length: int = 2048
    tokenizer_padding_side: str = "right"

    # ----- framework -----
    dtype: str = "bfloat16"            # activation/computation dtype
    param_dtype: str = "float32"       # master parameter dtype
    remat: bool = True                 # gradient checkpointing via jax.checkpoint
    loss_chunk: int = 128              # training CE in sequence chunks of this
                                       # many tokens (0 = whole-sequence fp32
                                       # logits). Identical math, but the fp32
                                       # [B, S, vocab] logits never exist —
                                       # 15.7 GB of the 8B stage-2 per-device
                                       # temps (r4 TPU compile, PERF_NOTES).
    scan_layers: bool = False          # lax.scan over decoder layers (uniform stacks)
    seq_shard_activations: bool = True  # training only: pin the residual
                                       # stream between decoder layers to
                                       # P((data, fsdp), model, None) so the
                                       # remat-saved carries shard over the
                                       # model axis too (sequence parallelism
                                       # for stored activations; 4x smaller at
                                       # 34B on (1,2,4)). No-op when no mesh /
                                       # no model axis / seq not divisible.
    quantize: Optional[str] = None     # "int8": weight-only quantized decoder
                                       # GEMMs (ops/quant.py, load_8bit path)
    lm_head_dtype: Optional[str] = None  # "bf16": store the vocab head bf16
                                       # and run its GEMM bf16 with fp32
                                       # accumulation (serving option; the
                                       # default keeps the reference's fp32
                                       # logits contract, cambrian_llama.py:409)

    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.hidden_size // self.num_attention_heads
        # tuples survive json round-trips as lists
        self.query_num_list = tuple(self.query_num_list)
        self.mm_vision_tower_aux_list = tuple(self.mm_vision_tower_aux_list)
        self.mm_vision_tower_aux_token_len_list = tuple(
            self.mm_vision_tower_aux_token_len_list
        )
        assert self.num_query_group == len(self.query_num_list)

    # -- SVA derived geometry ------------------------------------------------
    @property
    def image_token_len_per_side(self) -> int:
        return int(self.image_token_len ** 0.5)

    @property
    def image_block_len(self) -> int:
        """Image slots incl. the newline column (576 + 24 = 600)."""
        return self.image_token_len + self.image_token_len_per_side

    def cross_att_window_sizes(self, query_num: Optional[int] = None) -> List[int]:
        """Per-tower spatial window side length for a query grid
        (cambrian_arch.py:53,59): aux_side // query_side."""
        query_num = self.image_token_len if query_num is None else query_num
        q_side = int(query_num ** 0.5)
        return [
            int(tok ** 0.5) // q_side for tok in self.mm_vision_tower_aux_token_len_list
        ]

    @property
    def vision_sampler_layer_indices(self) -> List[int]:
        """Decoder layer indices that run an in-LLM SVA step
        (cambrian_llama.py:170-174)."""
        if self.connector_only:
            return []
        return [
            self.start_of_vision_sampler_layers + k * self.stride_of_vision_sampler_layers
            for k in range(self.num_of_vision_sampler_layers)
        ]

    # -- (de)serialization ----------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict) -> "CambrianConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json(cls, s: str) -> "CambrianConfig":
        return cls.from_dict(json.loads(s))

    def replace(self, **kwargs) -> "CambrianConfig":
        return dataclasses.replace(self, **kwargs)


# ---------------------------------------------------------------------------
# Stock decoder configs (HF architecture hyperparameters; public values)
# ---------------------------------------------------------------------------

LLAMA3_8B = dict(
    model_type="llama", vocab_size=128256, hidden_size=4096,
    intermediate_size=14336, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=8, rope_theta=500000.0, rms_norm_eps=1e-5,
    max_position_embeddings=8192, bos_token_id=128000, eos_token_id=128001,
)

VICUNA_13B = dict(
    model_type="llama", vocab_size=32000, hidden_size=5120,
    intermediate_size=13824, num_hidden_layers=40, num_attention_heads=40,
    num_key_value_heads=40, rope_theta=10000.0, rms_norm_eps=1e-5,
    max_position_embeddings=4096, bos_token_id=1, eos_token_id=2,
)

YI_34B = dict(
    model_type="llama", vocab_size=64000, hidden_size=7168,
    intermediate_size=20480, num_hidden_layers=60, num_attention_heads=56,
    num_key_value_heads=8, rope_theta=5000000.0, rms_norm_eps=1e-5,
    max_position_embeddings=4096, bos_token_id=1, eos_token_id=2,
)

GEMMA_7B = dict(
    model_type="gemma", vocab_size=256000, hidden_size=3072,
    intermediate_size=24576, num_hidden_layers=28, num_attention_heads=16,
    num_key_value_heads=16, head_dim=256, rope_theta=10000.0,
    rms_norm_eps=1e-6, max_position_embeddings=8192, tie_word_embeddings=True,
    hidden_act="gelu_pytorch_tanh", bos_token_id=2, eos_token_id=1,
)

COMMAND_R_35B = dict(
    model_type="cohere", vocab_size=256000, hidden_size=8192,
    intermediate_size=22528, num_hidden_layers=40, num_attention_heads=64,
    num_key_value_heads=64, rope_theta=8000000.0, rms_norm_eps=1e-5,
    max_position_embeddings=8192, tie_word_embeddings=True,
    logit_scale=0.0625, bos_token_id=5, eos_token_id=255001,
)

PHI3_MINI = dict(
    model_type="phi3", vocab_size=32064, hidden_size=3072,
    intermediate_size=8192, num_hidden_layers=32, num_attention_heads=32,
    num_key_value_heads=32, rope_theta=10000.0, rms_norm_eps=1e-5,
    max_position_embeddings=4096, bos_token_id=1, eos_token_id=32000,
    sliding_window=2048,
)

# Production 4-tower SVA setup (pretrain_cambrian_8b.sh:15-27)
CAMBRIAN_SVA = dict(
    mm_projector_type="sva",
    vision_hidden_size=1024,
    num_query_group=1,
    query_num_list=(576,),
    connector_depth=3,
    connector_only=False,
    num_of_vision_sampler_layers=10,
    start_of_vision_sampler_layers=0,
    stride_of_vision_sampler_layers=3,
    image_token_len=576,
    image_position=91,
    mm_vision_tower_aux_token_len_list=(576, 576, 576, 9216),
)


def cambrian_8b() -> CambrianConfig:
    return CambrianConfig(**{**LLAMA3_8B, **CAMBRIAN_SVA})


def cambrian_13b() -> CambrianConfig:
    # 13B geometry (pretrain_cambrian_13b.sh:23-28): image at position 35,
    # 10 in-LLM sampler layers every 4th layer.
    return CambrianConfig(**{
        **VICUNA_13B, **CAMBRIAN_SVA,
        "image_position": 35,
        "stride_of_vision_sampler_layers": 4,
    })


def cambrian_34b() -> CambrianConfig:
    # 34B geometry diverges from 8B (pretrain_cambrian_34b.sh:23-28):
    # image at position 87, 9 in-LLM sampler layers every 7th layer.
    return CambrianConfig(**{
        **YI_34B, **CAMBRIAN_SVA,
        "image_position": 87,
        "num_of_vision_sampler_layers": 9,
        "stride_of_vision_sampler_layers": 7,
    })


def cambrian_phi3() -> CambrianConfig:
    return CambrianConfig(**{**PHI3_MINI, **CAMBRIAN_SVA, "image_position": 35})


def tiny_debug(num_towers: int = 2) -> CambrianConfig:
    """Small-but-complete config exercising the full architecture (used by
    tests, __graft_entry__ and CPU-mesh dry runs)."""
    return CambrianConfig(
        model_type="llama",
        vocab_size=512,
        hidden_size=128,
        intermediate_size=256,
        num_hidden_layers=4,
        num_attention_heads=4,
        num_key_value_heads=2,
        rope_theta=10000.0,
        max_position_embeddings=1024,
        bos_token_id=1,
        eos_token_id=2,
        vision_hidden_size=64,
        num_query_group=1,
        query_num_list=(16,),
        connector_depth=2,
        connector_only=False,
        num_of_vision_sampler_layers=2,
        start_of_vision_sampler_layers=0,
        stride_of_vision_sampler_layers=2,
        image_token_len=16,
        image_position=5,
        mm_vision_tower_aux_list=tuple(f"debug-tower-{i}" for i in range(num_towers)),
        mm_vision_tower_aux_token_len_list=tuple(
            16 if i % 2 == 0 else 64 for i in range(num_towers)
        ),
        tokenizer_model_max_length=96,
    )
