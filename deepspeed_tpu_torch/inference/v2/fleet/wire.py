"""KV page wire format: the serialized leg of the prefill->decode fabric (port
of ``deepspeed_tpu/inference/v2/fleet/wire.py``; frames are byte for byte
the JAX package's, so a frame encoded by one package decodes in the other).

The quantized page layout is the wire format: int8 pools ship their
``(int8 data, fp32 per-token scale)`` pages byte for byte, a lossless round
trip, so greedy parity across a process boundary is exact. fp16 / fp32 /
bf16 pools quantize at the wire with ``block_quantize`` (kernel row 5, one
group per token row over head_dim, the int8 pool's layout) for about a 4x
(fp32) or 2x (bf16) smaller frame; that leg is lossy by design.

Where each step runs: the quantization runs on the SOURCE device, before
the pages land on the host (on a card, the row-5 kernel); the landing goes
through the caller's accounted fetch (the engine's ``host_fetch``); the
dequantization runs on the DESTINATION device after the pages land there
(``block_dequantize``, kernel row 6). On CPU tensors both run their plain
versions. bf16 pages with ``wire_quantize=False`` cross as their raw 16-bit
patterns (no numpy bfloat16 type is needed on either side).

Frame layout (little-endian)::

    MAGIC "DSKV" | version u16 | flags u16 | meta_len u32 | meta JSON | pages

``meta`` carries the page geometry, per-sequence adoption metadata (uid,
seen_tokens, tokens, delta-ship ``skipped_digests`` as hex), and one CRC32
per page. The payload is page-major — page *j* is the concatenation of its
K data, V data (and K / V scale rows when present) — so a flipped byte is
localized to one page and surfaces as a typed :class:`WireCRCError` (the
transport's retryable fault), while a version skew raises
:class:`WireVersionError` (a deterministic reject, never retried). Only the
``n`` real page rows ship; the port's decoder returns exactly ``n`` rows
(it has no transfer buckets to pad to).
"""

import json
import math
import struct
import zlib

import numpy as np
import torch

from deepspeed_tpu_torch.inference.v2.ragged.kv_cache import split_pages
from deepspeed_tpu_torch.ops import quant_collective as qc

MAGIC = b"DSKV"
VERSION = 1

_FLAG_QUANTIZED = 1       # pool pages are int8 + fp32 scales (as-is wire)
_FLAG_WIRE_QUANTIZED = 2  # fp pool quantized at the wire (lossy leg)

_HEADER = struct.Struct("<4sHHI")

# wire dtype names (numpy's, as the JAX package writes them) <-> torch
_TORCH = {"int8": torch.int8, "float32": torch.float32,
          "float16": torch.float16, "bfloat16": torch.bfloat16}
_NAME = {v: k for k, v in _TORCH.items()}


class WireError(RuntimeError):
    """Base class for wire-format failures."""


class WireVersionError(WireError):
    """Header rejected: bad magic or a version this build doesn't speak.
    Deterministic — retrying the same frame cannot help."""


class WireCRCError(WireError):
    """A page's CRC32 didn't match: bytes corrupted in flight. Retryable —
    the source re-serializes from its (still intact) export."""

    def __init__(self, page, detail=""):
        super().__init__(f"CRC mismatch on wire page {page}{detail}")
        self.page = page


def _land(t, fetch, what):
    """A tensor on the host, through the accounted fetch when given."""
    return fetch(t, what) if fetch is not None else t.detach().to("cpu")


def _to_numpy(t):
    """CPU tensor -> numpy; bf16 as its raw uint16 pattern."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16)
    return t.contiguous().numpy()


def _from_numpy(a, name):
    """numpy array (bf16 as uint16 patterns) -> CPU tensor of wire dtype
    ``name``."""
    if not a.flags.writeable:              # a view of the frame's bytes
        a = a.copy()
    if name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _page_major(a, n):
    """[L, B, ...] -> contiguous [n, L, ...] (rows past n dropped)."""
    return np.ascontiguousarray(np.moveaxis(a[:, :n], 1, 0))


def _quantize_pages(data):
    """fp pages [L, n, H, bs, hd] on their device -> (int8 [same], fp32
    scale [L, n, H, 1, bs]) through ``block_quantize`` (row 5 on a card):
    one group per token row over head_dim, the int8 pool's scale layout."""
    L, n, H, bs, hd = data.shape
    q, scale = qc.block_quantize(data.reshape(L * n * H * bs, hd), num_bits=8,
                                 group_size=hd)
    return (q.reshape(L, n, H, bs, hd),
            scale.reshape(L, n, H, bs, 1).transpose(3, 4).contiguous())


def _dequantize_pages(q, scale):
    """Inverse of ``_quantize_pages`` on the tensors' device
    (``block_dequantize``, row 6 on a card): fp32 [L, n, H, bs, hd]."""
    L, n, H, bs, hd = q.shape
    rows = q.reshape(L * n * H * bs, hd)
    s = scale.transpose(3, 4).reshape(L * n * H * bs, 1)
    out = qc.block_dequantize(rows, s, num_bits=8, group_size=hd, out_len=hd,
                              dtype=torch.float32)
    return out.reshape(L, n, H, bs, hd)


def encode_handle(handle, fetch=None, wire_quantize=True):
    """Serialize an ``export_sequences_pages`` handle into one wire frame.

    ``fetch(tensor, what) -> cpu tensor`` is the engine's accounted
    device->host fetch (every landing is a real copy and shows up in the
    host-sync count). int8 pools serialize as-is; fp pools quantize at the
    wire on their device when ``wire_quantize`` (lossy), else ship raw page
    bytes."""
    n = int(handle["n"])
    k_data, k_scale = split_pages(handle["k"])
    v_data, v_scale = split_pages(handle["v"])
    quantized = k_scale is not None
    wire_quantized = bool(not quantized and wire_quantize and n)
    if wire_quantized:
        (k_data, k_scale) = _quantize_pages(k_data[:, :n])
        (v_data, v_scale) = _quantize_pages(v_data[:, :n])
    parts = [k_data, v_data] + ([k_scale, v_scale] if k_scale is not None else [])
    landed = [_page_major(_to_numpy(_land(p, fetch, "fleet/wire_encode")), n)
              for p in parts]
    names = [_NAME[p.dtype] for p in parts]
    # the payload, page-major: row j is page j's parts back to back
    body = np.concatenate([a.reshape(n, -1).view(np.uint8) for a in landed], axis=1)
    crcs = [zlib.crc32(row) for row in body]
    seqs = []
    for m in handle["seqs"]:
        e = {"uid": m["uid"], "n": int(m["n"]),
             "seen_tokens": int(m["seen_tokens"]),
             "tokens": [int(t) for t in m.get("tokens", [])]}
        if m.get("skipped"):
            e["skipped"] = int(m["skipped"])
            e["skipped_digests"] = [d.hex() for d in m["skipped_digests"]]
        seqs.append(e)
    keys = ("k", "v", "ks", "vs")
    meta = {"n": n,
            "geom": {p: list(a.shape[1:]) for p, a in zip(keys, landed)},
            "dtypes": dict(zip(keys, names)),
            "quantized": quantized, "wire_quantized": wire_quantized,
            "page_nbytes": int(body.shape[1]) if n else 0,
            "crcs": crcs, "seqs": seqs}
    mb = json.dumps(meta).encode()
    flags = (_FLAG_QUANTIZED if quantized else 0) \
        | (_FLAG_WIRE_QUANTIZED if wire_quantized else 0)
    return _HEADER.pack(MAGIC, VERSION, flags, len(mb)) + mb + body.tobytes()


def decode_frame(frame, device):
    """Parse and CRC-verify a wire frame into an import handle whose pages
    lie on ``device``.

    Raises :class:`WireVersionError` on magic/version skew (before touching
    any payload byte) and :class:`WireCRCError` on the first corrupt page.
    Returns ``{"n", "k", "v", "seqs", "wire_nbytes"}`` with pool-major page
    tensors of ``n`` rows (``(data, scale)`` pairs for int8 pools);
    wire-quantized fp pages come back dequantized to fp32 on ``device``
    (that leg is lossy by design) and the pool casts them on bind."""
    if len(frame) < _HEADER.size:
        raise WireVersionError(f"frame too short ({len(frame)} bytes)")
    magic, version, flags, meta_len = _HEADER.unpack_from(frame)
    if magic != MAGIC:
        raise WireVersionError(f"bad magic {magic!r}")
    if version != VERSION:
        raise WireVersionError(f"wire version {version}, expected {VERSION}")
    meta = json.loads(frame[_HEADER.size:_HEADER.size + meta_len])
    n, pn = int(meta["n"]), int(meta["page_nbytes"])
    body = memoryview(frame)[_HEADER.size + meta_len:]
    for j in range(n):
        raw = body[j * pn:(j + 1) * pn]
        if len(raw) < pn:
            raise WireCRCError(j, " (truncated frame)")
        if zlib.crc32(raw) != meta["crcs"][j]:
            raise WireCRCError(j)
    pages = np.frombuffer(body, np.uint8, count=n * pn).reshape(n, pn)
    parts, off = {}, 0
    for name, shape in meta["geom"].items():  # insertion == serialization order
        dname = meta["dtypes"][name]
        np_dt = np.uint16 if dname == "bfloat16" else np.dtype(dname)
        nb = math.prod(shape) * np.dtype(np_dt).itemsize
        a = np.ascontiguousarray(pages[:, off:off + nb]).view(np_dt)
        a = a.reshape((n,) + tuple(shape))
        # page-major [n, L, ...] -> pool-major [L, n, ...] on the device
        parts[name] = _from_numpy(np.ascontiguousarray(np.moveaxis(a, 0, 1)),
                                  dname).to(device)
        off += nb
    if meta["wire_quantized"]:
        k = _dequantize_pages(parts["k"], parts["ks"])
        v = _dequantize_pages(parts["v"], parts["vs"])
    elif meta["quantized"]:
        k = (parts["k"], parts["ks"])
        v = (parts["v"], parts["vs"])
    else:
        k, v = parts["k"], parts["v"]
    seqs = []
    for e in meta["seqs"]:
        m = {"uid": e["uid"], "n": int(e["n"]),
             "seen_tokens": int(e["seen_tokens"]), "tokens": e["tokens"]}
        if e.get("skipped"):
            m["skipped"] = int(e["skipped"])
            m["skipped_digests"] = [bytes.fromhex(d) for d in e["skipped_digests"]]
        seqs.append(m)
    return {"n": n, "k": k, "v": v, "seqs": seqs, "wire_nbytes": len(frame)}


def corrupt(frame, offset=-1):
    """Flip one payload byte (fault injection / tests). ``offset`` indexes
    from the end so the default lands in page bytes, not the header."""
    b = bytearray(frame)
    b[offset] ^= 0xFF
    return bytes(b)


# -- wire accounting (bytes on a link, not device page bytes) ----------------
def _row_nbytes(t):
    """Bytes of one block row of a pool-major page tensor [L, B, ...]."""
    return math.prod(t.shape[:1] + t.shape[2:]) * t.element_size()


def page_wire_nbytes(k, v):
    """Per-page wire bytes of an exported page group: data + scale bytes of
    one block row."""
    total = 0
    for part in (k, v):
        data, scale = split_pages(part)
        total += _row_nbytes(data)
        if scale is not None:
            total += _row_nbytes(scale)
    return total


def page_fp32_nbytes(k, v):
    """Per-page bytes the same geometry would cost at fp32: the denominator
    of the wire-bytes ratio."""
    total = 0
    for part in (k, v):
        data, _ = split_pages(part)
        total += 4 * _row_nbytes(data) // data.element_size()
    return total
