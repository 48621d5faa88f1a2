"""Read and write SPADE checkpoints in the JAX package's format, without
flax or msgpack.

``spade_train.py`` writes ``flax.serialization.to_bytes`` of the whole
TrainState: a msgpack map whose arrays are ext type 1, themselves a msgpack
``(shape, dtype name, C-order bytes)`` triple, and whose numpy scalars are
ext type 3 of the same triple.  :func:`unpackb` decodes exactly that subset
of msgpack (maps, arrays, str/bin, ints, floats, nil/bool and those two ext
types) and raises on anything else, including flax's chunked form of an
array over 2^30 bytes (the largest full-width kernel is ~38 MB).
Arrays are read-only numpy views of the input bytes.  :func:`packb` writes
the same subset with msgpack's smallest encodings, as flax's
``msgpack_serialize`` does.
"""

from __future__ import annotations

import os
import struct

import numpy as np

EXT_NDARRAY = 1
EXT_NPSCALAR = 3
CHUNKED_MARKER = "__msgpack_chunked_array__"
_CONSTANTS = {0xC0: None, 0xC2: False, 0xC3: True}
_FIXED = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}


class _Reader:
    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, code: int, base: int) -> int:
        """The big-endian length after an 8/16/32-bit type code."""
        return self.unpack((">B", ">H", ">I")[code - base])

    def value(self):
        c = self.unpack(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.array(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.text(c & 0x1F)
        if c in _CONSTANTS:
            return _CONSTANTS[c]
        if 0xC4 <= c <= 0xC6:
            return bytes(self.take(self.length(c, 0xC4)))
        if 0xC7 <= c <= 0xC9:
            n = self.length(c, 0xC7)
            return self.ext(self.unpack(">b"), n)
        if c in _FIXED:
            return self.unpack(_FIXED[c])
        if 0xD4 <= c <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (c - 0xD4))
        if 0xD9 <= c <= 0xDB:
            return self.text(self.length(c, 0xD9))
        if c in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if c == 0xDC else ">I"))
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if c == 0xDE else ">I"))
        raise ValueError(f"msgpack: type byte {c:#04x} is not in the checkpoint subset")

    def text(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        if CHUNKED_MARKER in out:
            raise ValueError("msgpack: flax's chunked array (over 2^30 bytes) is not supported")
        return out

    def ext(self, code: int, n: int):
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: ext type {code} is not in the checkpoint subset")
        r = _Reader(self.take(n))
        if r.unpack(">B") != 0x93:
            raise ValueError("msgpack: an array ext is not a (shape, dtype, bytes) triple")
        shape, dtype = r.value(), r.value()
        c = r.unpack(">B")
        if not 0xC4 <= c <= 0xC6:
            raise ValueError("msgpack: an array ext holds no bytes")
        raw = r.take(r.length(c, 0xC4))  # a view of the input, not a copy
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape)
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    """The tree that ``flax.serialization.msgpack_restore`` gives for
    ``data``: dicts, lists, Python scalars, numpy arrays and scalars."""
    r = _Reader(data)
    out = r.value()
    if r.pos != len(r.buf):
        raise ValueError("msgpack: trailing bytes after the checkpoint")
    return out


def load_generator_variables(path: str) -> dict:
    """The generator's flax variables, ``{"params": g_params,
    "batch_stats": g_batch_stats}``, from a JAX package TrainState
    checkpoint (``*.msgpack``); with a VAE the encoder rides inside them
    under ``enc``."""
    with open(path, "rb") as f:
        state = unpackb(f.read())
    return {"params": state["g_params"], "batch_stats": state["g_batch_stats"]}


MAX_ARRAY_BYTES = 1 << 30  # flax chunks larger arrays; the writer refuses them


def _head(n: int, fix: int | None, fixmax: int, codes: tuple[int, ...]) -> bytes:
    """A length header: the fix form up to ``fixmax``, else the 8-bit (where
    ``codes`` has three), 16-bit or 32-bit form."""
    if fix is not None and n <= fixmax:
        return bytes([fix | n])
    for code, fmt in zip(codes, (">B", ">H", ">I")[-len(codes):]):
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError("msgpack: object too large")


def _int(x: int) -> bytes:
    if 0 <= x <= 0x7F or -32 <= x < 0:
        return struct.pack(">b" if x < 0 else ">B", x)
    forms = ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")) if x >= 0 else \
        ((0xD0, ">b"), (0xD1, ">h"), (0xD2, ">i"), (0xD3, ">q"))
    for code, fmt in forms:
        bits = 8 * struct.calcsize(fmt)
        if (x < 1 << bits) if x >= 0 else (x >= -(1 << (bits - 1))):
            return bytes([code]) + struct.pack(fmt, x)
    raise ValueError(f"msgpack: integer {x} out of range")


def _ext(code: int, payload: bytes) -> bytes:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes([fixed[n]]) if n in fixed else _head(n, None, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code) + payload


def packb(obj) -> bytes:
    """msgpack bytes of a tree of dicts (str keys), lists, str, bytes, bool,
    None, Python ints and floats, numpy arrays (ext 1) and numpy scalars
    (ext 3): the bytes ``flax.serialization.msgpack_serialize`` writes,
    which orders each map's keys as JAX's tree functions sort them."""
    if isinstance(obj, dict):
        return _head(len(obj), 0x80, 15, (0xDE, 0xDF)) + b"".join(
            packb(k) + packb(obj[k]) for k in sorted(obj))
    if isinstance(obj, (list, tuple)):
        return _head(len(obj), 0x90, 15, (0xDC, 0xDD)) + b"".join(map(packb, obj))
    if isinstance(obj, (np.ndarray, np.generic)):
        a = np.asarray(obj)
        if a.nbytes >= MAX_ARRAY_BYTES:
            raise ValueError("msgpack: arrays of 2^30 bytes or more are chunked by flax; "
                             "not supported")
        payload = packb([list(a.shape), a.dtype.name, np.ascontiguousarray(a).tobytes()])
        return _ext(EXT_NDARRAY if isinstance(obj, np.ndarray) else EXT_NPSCALAR, payload)
    if obj is None or isinstance(obj, bool):
        return bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[obj]])
    if isinstance(obj, int):
        return _int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        raw = obj.encode()
        return _head(len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + raw
    if isinstance(obj, bytes):
        return _head(len(obj), None, -1, (0xC4, 0xC5, 0xC6)) + obj
    raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def save_train_state(path: str, tree: dict) -> None:
    """Write a training state's flax-layout tree (``SpadeTrainer.state_to_numpy``)
    as the JAX package's ``latest.msgpack``; the file is replaced whole."""
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(packb(tree))
    os.replace(tmp, path)


def load_train_state(path: str) -> dict:
    """The whole training state's tree from a checkpoint of either package."""
    with open(path, "rb") as f:
        return unpackb(f.read())
