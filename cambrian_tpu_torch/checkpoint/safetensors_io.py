"""The safetensors file format, read and written without the ``safetensors``
package (machines that serve the port need not have it).

A file is an 8-byte little-endian header length, a UTF-8 JSON header
``{name: {"dtype", "shape", "data_offsets": [begin, end]}, "__metadata__":
{str: str}}``, padded with spaces, then the tensors' raw little-endian bytes,
back to back in header order. A sharded checkpoint is several such files
plus ``model.safetensors.index.json`` (``{"metadata": {"total_size"},
"weight_map": {name: file}}``).

Reads give numpy arrays; BF16, which numpy lacks, comes back upcast to
fp32 (exactly), as the JAX package's loader upcasts a ``.bin`` shard's bf16
tensors. Writes take numpy arrays or torch tensors, so a bf16 tensor can be
written as BF16.
"""

import json
import os
import struct
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

# safetensors dtype -> little-endian numpy dtype of the stored bytes
_NUMPY = {
    "F32": np.dtype("<f4"), "F16": np.dtype("<f2"), "BF16": np.dtype("<u2"),
    "I8": np.dtype("i1"), "U8": np.dtype("u1"), "I32": np.dtype("<i4"),
    "I64": np.dtype("<i8"), "BOOL": np.dtype("?"),
}
_FROM_NUMPY = {np.dtype(np.float32): "F32", np.dtype(np.float16): "F16",
               np.dtype(np.int8): "I8", np.dtype(np.uint8): "U8",
               np.dtype(np.int32): "I32", np.dtype(np.int64): "I64",
               np.dtype(np.bool_): "BOOL"}
_FROM_TORCH = {torch.float32: "F32", torch.float16: "F16", torch.bfloat16: "BF16",
               torch.int8: "I8", torch.uint8: "U8", torch.int32: "I32",
               torch.int64: "I64", torch.bool: "BOOL"}
# the bytes of a tensor of each dtype, as a torch dtype numpy can hold
_TORCH_BITS = {torch.bfloat16: torch.int16}

INDEX_NAME = "model.safetensors.index.json"
Tensor = Union[np.ndarray, torch.Tensor]


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
    """uint16 bf16 bit patterns -> fp32 values (the bits are fp32's top half)."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _read_header(f) -> tuple:
    raw = f.read(8)
    if len(raw) != 8:
        raise ValueError(f"{f.name}: shorter than a safetensors header")
    (n,) = struct.unpack("<Q", raw)
    header = json.loads(f.read(n).decode("utf-8"))
    if not isinstance(header, dict):
        raise ValueError(f"{f.name}: the header is not a JSON object")
    return header, 8 + n


def load_file(path: str) -> Dict[str, np.ndarray]:
    """{name: numpy array} of one safetensors file; BF16 upcast to fp32."""
    out = {}
    with open(path, "rb") as f:
        header, base = _read_header(f)
        end_of_file = os.fstat(f.fileno()).st_size
        for name, info in header.items():
            if name == "__metadata__":
                continue
            code = info["dtype"]
            if code not in _NUMPY:
                raise TypeError(f"{path}: {name} has dtype {code}, which this reader "
                                f"does not take ({sorted(_NUMPY)})")
            dtype, shape = _NUMPY[code], tuple(info["shape"])
            begin, end = info["data_offsets"]
            count = int(np.prod(shape, dtype=np.int64))
            if end - begin != count * dtype.itemsize or base + end > end_of_file:
                raise ValueError(f"{path}: {name} {code}{list(shape)} does not fit its "
                                 f"offsets {begin}..{end}")
            f.seek(base + begin)
            arr = np.fromfile(f, dtype=dtype, count=count).reshape(shape)
            out[name] = _bf16_to_f32(arr) if code == "BF16" else arr
    return out


def _code_and_bytes(name: str, t: Tensor):
    """(safetensors dtype, shape, a contiguous numpy array of its bytes)."""
    if isinstance(t, torch.Tensor):
        if t.dtype not in _FROM_TORCH:
            raise TypeError(f"{name}: dtype {t.dtype} cannot be written")
        t = t.detach().cpu().contiguous()
        shape = tuple(t.shape)
        code = _FROM_TORCH[t.dtype]
        t = t.view(_TORCH_BITS.get(t.dtype, t.dtype))
        return code, shape, t.numpy()
    arr = np.asarray(t)
    if arr.dtype not in _FROM_NUMPY:
        raise TypeError(f"{name}: dtype {arr.dtype} cannot be written")
    code = _FROM_NUMPY[arr.dtype]
    return code, arr.shape, np.ascontiguousarray(arr.astype(_NUMPY[code], copy=False))


def save_file(tensors: Mapping[str, Tensor], path: str,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` to one safetensors file, in the mapping's order;
    returns the bytes written."""
    parts, header, offset = [], {}, 0
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    for name, t in tensors.items():
        code, shape, data = _code_and_bytes(name, t)
        header[name] = {"dtype": code, "shape": list(shape),
                        "data_offsets": [offset, offset + data.nbytes]}
        parts.append(data)
        offset += data.nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)                 # the buffers start 8-byte aligned
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for data in parts:
            f.write(memoryview(data.reshape(-1)).cast("B"))
    return 8 + len(raw) + offset


def save_sharded(tensors: Mapping[str, Tensor], directory: str,
                 shard_size_bytes: int = 4 * 1024 ** 3) -> int:
    """Write ``model.safetensors``, or, past ``shard_size_bytes``,
    ``model-0000i-of-0000n.safetensors`` shards and their index (a tensor
    larger than a shard gets one to itself); returns the bytes written."""
    shards, cur, cur_bytes = [], {}, 0
    for name, t in tensors.items():
        n = _nbytes(t)
        if cur and cur_bytes + n > shard_size_bytes:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[name] = t
        cur_bytes += n
    if cur or not shards:
        shards.append(cur)
    os.makedirs(directory, exist_ok=True)
    if len(shards) == 1:
        return save_file(shards[0], os.path.join(directory, "model.safetensors"))
    written, weight_map = 0, {}
    for i, shard in enumerate(shards):
        fname = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        written += save_file(shard, os.path.join(directory, fname))
        weight_map.update({name: fname for name in shard})
    index = {"metadata": {"total_size": sum(_nbytes(t) for t in tensors.values())},
             "weight_map": weight_map}
    raw = json.dumps(index, indent=2).encode("utf-8")
    with open(os.path.join(directory, INDEX_NAME), "wb") as f:
        f.write(raw)
    return written + len(raw)


def _nbytes(t: Tensor) -> int:
    if isinstance(t, torch.Tensor):
        return t.numel() * t.element_size()
    return np.asarray(t).nbytes
