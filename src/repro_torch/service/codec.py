"""Wire codecs: the payload encodings behind the length-prefixed framing,
the counterpart of ``repro.service.codec``.

Every frame on a wire connection is ``4-byte big-endian length +
payload``; a *codec* decides how the payload dict is encoded. Three codecs
exist, each producing the same bytes as the reference's for the same
object, so processes of the two packages talk to each other:

* ``json`` — UTF-8 JSON. Every peer speaks it; it is the codec every
  connection starts in and the negotiation fallback.
* ``msgpack`` — binary MessagePack via the ``msgpack`` package, when it is
  importable (an optional import: never a hard dependency). Floats are
  packed as IEEE-754 float64 (bit-exact), ints as native integer
  families, strings as UTF-8.
* ``tlv`` — a stdlib-only tag-length-value encoding with msgpack-style
  tags, used where ``msgpack`` is not installed. Floats are packed
  ``">d"`` so they round-trip bit-exactly.

All three encode exactly the JSON data model (None/bool/int/float/str +
lists + str-keyed dicts; the binary codecs also pass ``bytes`` through)
and are self-inverse: ``decode(encode(x)) == x`` with float *bits*
preserved, including ``nan``/``inf``/``-0.0``, for Python floats and
ints. A numpy scalar or a 0-d tensor is not in the data model: JSON
refuses an ``np.int64`` or ``np.float32``, so payload builders convert
such values to Python numbers first (``repro_torch.service.dispatch``).

``get_codec(name)`` resolves a codec by name; ``"binary"`` is an alias
for the best available binary codec (msgpack, else tlv). Negotiation
happens per connection via the ``_wire`` hello (see
``repro_torch.service.transport``), exchanging these concrete names so
mismatched peers fall back to JSON safely.
"""
from __future__ import annotations

import json
import struct
from typing import Any, Dict, List, Tuple

__all__ = ["Codec", "JsonCodec", "TLVCodec", "CodecError",
           "available_codecs", "best_binary_codec", "get_codec", "plain"]

try:                                     # optional
    import msgpack as _msgpack
except ImportError:                      # pragma: no cover - env dependent
    _msgpack = None


class CodecError(ValueError):
    """Payload could not be encoded/decoded by the connection's codec."""


class Codec:
    """``encode(obj) -> bytes`` / ``decode(bytes) -> obj`` + a wire name."""

    name: str = "?"

    def encode(self, obj: Any) -> bytes:
        raise NotImplementedError

    def decode(self, data: bytes) -> Any:
        raise NotImplementedError


class JsonCodec(Codec):
    name = "json"

    def encode(self, obj: Any) -> bytes:
        try:
            return json.dumps(obj).encode("utf-8")
        except (TypeError, ValueError) as e:
            raise CodecError(f"json encode failed: {e}") from None

    def decode(self, data: bytes) -> Any:
        try:
            return json.loads(data.decode("utf-8"))
        except (UnicodeDecodeError, ValueError) as e:
            raise CodecError(f"json decode failed: {e}") from None


class MsgpackCodec(Codec):
    name = "msgpack"

    def encode(self, obj: Any) -> bytes:
        try:
            return _msgpack.packb(obj, use_bin_type=True)
        except Exception as e:           # noqa: BLE001 — wire boundary
            raise CodecError(f"msgpack encode failed: {e}") from None

    def decode(self, data: bytes) -> Any:
        try:
            return _msgpack.unpackb(data, raw=False, strict_map_key=False)
        except Exception as e:           # noqa: BLE001 — wire boundary
            raise CodecError(f"msgpack decode failed: {e}") from None


# ---------------------------------------------------------------------------
# TLV: stdlib-only binary fallback (msgpack-style tags, fixed-width lengths)
# ---------------------------------------------------------------------------

_T_NONE = 0xC0
_T_FALSE = 0xC2
_T_TRUE = 0xC3
_T_BIN = 0xC6        # + u32 len + raw bytes
_T_BIGINT = 0xC7     # + u32 len + sign byte + big-endian magnitude
_T_FLOAT64 = 0xCB    # + 8 bytes ">d"
_T_INT64 = 0xD3      # + 8 bytes ">q"
_T_STR = 0xDB        # + u32 len + UTF-8
_T_ARRAY = 0xDD      # + u32 count + items
_T_MAP = 0xDF        # + u32 count + (str key, value) pairs

_U32 = struct.Struct(">I")
_I64 = struct.Struct(">q")
_F64 = struct.Struct(">d")
_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1


class TLVCodec(Codec):
    name = "tlv"

    def encode(self, obj: Any) -> bytes:
        out = bytearray()
        self._enc(obj, out)
        return bytes(out)

    def _enc(self, obj: Any, out: bytearray) -> None:
        if obj is None:
            out.append(_T_NONE)
        elif obj is True:
            out.append(_T_TRUE)
        elif obj is False:
            out.append(_T_FALSE)
        elif isinstance(obj, bool):      # numpy.bool_ etc. never reach here
            out.append(_T_TRUE if obj else _T_FALSE)
        elif isinstance(obj, int):
            if _I64_MIN <= obj <= _I64_MAX:
                out.append(_T_INT64)
                out += _I64.pack(obj)
            else:                        # JSON handles bigints; so do we
                mag = abs(obj)
                raw = mag.to_bytes((mag.bit_length() + 7) // 8 or 1, "big")
                out.append(_T_BIGINT)
                out += _U32.pack(len(raw) + 1)
                out.append(1 if obj < 0 else 0)
                out += raw
        elif isinstance(obj, float):
            out.append(_T_FLOAT64)
            out += _F64.pack(obj)
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            out.append(_T_STR)
            out += _U32.pack(len(raw))
            out += raw
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            raw = bytes(obj)
            out.append(_T_BIN)
            out += _U32.pack(len(raw))
            out += raw
        elif isinstance(obj, (list, tuple)):
            out.append(_T_ARRAY)
            out += _U32.pack(len(obj))
            for item in obj:
                self._enc(item, out)
        elif isinstance(obj, dict):
            out.append(_T_MAP)
            out += _U32.pack(len(obj))
            for k, v in obj.items():
                if not isinstance(k, str):
                    raise CodecError(
                        f"tlv map keys must be str, got {type(k).__name__}")
                self._enc(k, out)
                self._enc(v, out)
        else:
            raise CodecError(
                f"tlv cannot encode {type(obj).__name__} (JSON data "
                "model only: None/bool/int/float/str/bytes/list/dict)")

    def decode(self, data: bytes) -> Any:
        view = memoryview(data)
        obj, pos = self._dec(view, 0)
        if pos != len(view):
            raise CodecError(
                f"tlv payload has {len(view) - pos} trailing byte(s)")
        return obj

    def _dec(self, view: memoryview, pos: int) -> Tuple[Any, int]:
        try:
            tag = view[pos]
        except IndexError:
            raise CodecError("truncated tlv payload") from None
        pos += 1
        try:
            if tag == _T_NONE:
                return None, pos
            if tag == _T_TRUE:
                return True, pos
            if tag == _T_FALSE:
                return False, pos
            if tag == _T_INT64:
                return _I64.unpack_from(view, pos)[0], pos + 8
            if tag == _T_FLOAT64:
                return _F64.unpack_from(view, pos)[0], pos + 8
            if tag == _T_STR:
                (n,) = _U32.unpack_from(view, pos)
                pos += 4
                raw = bytes(view[pos:pos + n])
                if len(raw) != n:
                    raise CodecError("truncated tlv payload")
                return raw.decode("utf-8"), pos + n
            if tag == _T_BIN:
                (n,) = _U32.unpack_from(view, pos)
                pos += 4
                raw = bytes(view[pos:pos + n])
                if len(raw) != n:
                    raise CodecError("truncated tlv payload")
                return raw, pos + n
            if tag == _T_BIGINT:
                (n,) = _U32.unpack_from(view, pos)
                pos += 4
                raw = bytes(view[pos:pos + n])
                if len(raw) != n or n < 1:
                    raise CodecError("truncated tlv payload")
                val = int.from_bytes(raw[1:], "big")
                return (-val if raw[0] else val), pos + n
            if tag == _T_ARRAY:
                (n,) = _U32.unpack_from(view, pos)
                pos += 4
                items: List[Any] = []
                for _ in range(n):
                    item, pos = self._dec(view, pos)
                    items.append(item)
                return items, pos
            if tag == _T_MAP:
                (n,) = _U32.unpack_from(view, pos)
                pos += 4
                out: Dict[str, Any] = {}
                for _ in range(n):
                    key, pos = self._dec(view, pos)
                    if not isinstance(key, str):
                        raise CodecError("tlv map key is not a string")
                    out[key], pos = self._dec(view, pos)
                return out, pos
        except struct.error:
            raise CodecError("truncated tlv payload") from None
        except UnicodeDecodeError as e:
            raise CodecError(f"tlv string is not valid UTF-8: {e}") from None
        raise CodecError(f"unknown tlv tag 0x{tag:02x}")


def plain(obj: Any) -> Any:
    """``obj`` in the codecs' data model: every numpy scalar, 0-d array and
    0-d tensor replaced by the Python number it holds (``.item()``: exact
    for every float and int type; for a CUDA tensor it waits for the
    device), float subclasses such as ``np.float64`` by a ``float``, dicts
    and lists walked. Anything else is returned as it is, for the codec to
    accept or refuse."""
    if obj is None or type(obj) in (bool, int, float, str, bytes):
        return obj
    if isinstance(obj, dict):
        return {k: plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(plain(v) for v in obj)
    if isinstance(obj, float):
        return float(obj)
    if getattr(obj, "ndim", None) == 0 and callable(getattr(obj, "item",
                                                            None)):
        return obj.item()
    return obj


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_CODECS: Dict[str, Codec] = {"json": JsonCodec(), "tlv": TLVCodec()}
if _msgpack is not None:
    _CODECS["msgpack"] = MsgpackCodec()


def available_codecs() -> Tuple[str, ...]:
    """Concrete codec names this process can speak, binary-best first."""
    names = []
    if "msgpack" in _CODECS:
        names.append("msgpack")
    names += ["tlv", "json"]
    return tuple(names)


def best_binary_codec() -> Codec:
    return _CODECS.get("msgpack") or _CODECS["tlv"]


def get_codec(name: str) -> Codec:
    """Resolve a codec by concrete name; ``"binary"`` means the best
    available binary codec (msgpack when importable, else tlv)."""
    if name == "binary":
        return best_binary_codec()
    try:
        return _CODECS[name]
    except KeyError:
        raise CodecError(
            f"unknown wire codec {name!r}; available: "
            f"{', '.join(available_codecs())} (or 'binary')") from None
