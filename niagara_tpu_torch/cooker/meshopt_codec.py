"""The port's own copy of niagara_tpu/cooker/meshopt_codec.py, unchanged but
for this note.

EXT_meshopt_compression codecs (vertex / triangle / index-sequence) and
filters (octahedral, quaternion, exponential).

Matches the reference's use of meshoptimizer's buffer codecs for compressed
glTF content (reference scene.cpp:405-471 decodes the same three modes).
The byte formats follow the public meshoptimizer wire format:

  * vertex codec (mode ATTRIBUTES, header 0xa0): per-block, per-byte-lane
    zigzag deltas vs the previous vertex, packed in 16-delta groups at
    0/2/4/8 bits each with sentinel escapes; the first vertex rides in the
    buffer tail;
  * triangle codec (mode TRIANGLES, header 0xe1): edge fifo + vertex fifo
    prediction, one code byte per triangle, varint spill stream, and the
    16-entry codeaux table embedded in the last 16 bytes (v1);
  * index-sequence codec (mode INDICES, header 0xd1): zigzag varint deltas
    vs the last index.

Both directions are implemented; the encoders exist to round-trip-test the
decoders (this environment has no meshoptimizer binary or compressed asset
to verify against, so byte-level compatibility with upstream encoders is
asserted structurally: header bytes, group/bit layouts, fifo disciplines,
and the embedded-table mechanism that makes v1 decoders table-agnostic).
"""

from __future__ import annotations

import numpy as np

VERTEX_HEADER = 0xA0  # version 0
INDEX_HEADER = 0xE1  # triangle codec, version 1 (embedded codeaux table)
SEQUENCE_HEADER = 0xD1  # index sequence codec, version 1

_BYTE_GROUP = 16
_BLOCK_BYTES = 8192
_BLOCK_MAX = 256
_TAIL_MAX = 32


def _block_size(stride: int) -> int:
    n = _BLOCK_BYTES // stride
    n &= ~(_BYTE_GROUP - 1)
    return max(min(n, _BLOCK_MAX), _BYTE_GROUP)


def _zigzag8(d):
    d = np.asarray(d, np.uint8)
    return (((d.astype(np.int8).astype(np.int16) << 1) ^ (d.astype(np.int8).astype(np.int16) >> 7)) & 0xFF).astype(np.uint8)


def _unzigzag8(z):
    z = np.asarray(z, np.uint16)
    return (((z >> 1) ^ (-(z & 1)).astype(np.uint16)) & 0xFF).astype(np.uint8)


# ---------------------------------------------------------------- vertex v0


def _encode_group(out: bytearray, deltas: np.ndarray, bits: int):
    """One 16-delta group at a fixed bit width with sentinel escapes."""
    if bits == 0:
        return
    if bits == 8:
        out.extend(deltas.tobytes())
        return
    sentinel = (1 << bits) - 1
    clamped = np.minimum(deltas, sentinel)
    per_byte = 8 // bits
    packed = bytearray()
    for j in range(0, _BYTE_GROUP, per_byte):
        b = 0
        for t in range(per_byte):
            b = (b << bits) | int(clamped[j + t])
        packed.append(b)
    out.extend(packed)
    for v, c in zip(deltas, clamped):
        if c == sentinel and v >= sentinel:
            out.append(int(v))


def _group_size(deltas: np.ndarray, bits: int) -> int:
    if bits == 0:
        return 0 if not deltas.any() else 1 << 20  # invalid unless all zero
    if bits == 8:
        return _BYTE_GROUP
    sentinel = (1 << bits) - 1
    return _BYTE_GROUP * bits // 8 + int(np.sum(deltas >= sentinel))


def _decode_group(data: bytes, pos: int, bits: int) -> tuple[np.ndarray, int]:
    if bits == 0:
        return np.zeros(_BYTE_GROUP, np.uint8), pos
    if bits == 8:
        return np.frombuffer(data, np.uint8, _BYTE_GROUP, pos), pos + _BYTE_GROUP
    sentinel = (1 << bits) - 1
    per_byte = 8 // bits
    nbytes = _BYTE_GROUP // per_byte
    raw = np.frombuffer(data, np.uint8, nbytes, pos)
    pos += nbytes
    vals = np.zeros(_BYTE_GROUP, np.uint8)
    for j in range(nbytes):
        b = int(raw[j])
        for t in range(per_byte):
            shift = bits * (per_byte - 1 - t)
            vals[j * per_byte + t] = (b >> shift) & sentinel
    n_esc = int(np.sum(vals == sentinel))
    if n_esc:
        esc = np.frombuffer(data, np.uint8, n_esc, pos)
        pos += n_esc
        vals = vals.copy()
        vals[vals == sentinel] = esc
    return vals, pos


def encode_vertex_buffer(vertices: np.ndarray) -> bytes:
    """vertices: [count, stride] u8.  Returns the encoded byte stream."""
    v = np.ascontiguousarray(vertices, np.uint8)
    count, stride = v.shape
    assert 1 <= stride <= 256
    out = bytearray([VERTEX_HEADER])
    block = _block_size(stride)

    prev = v[0].copy()
    for b0 in range(0, count, block):
        blk = v[b0 : b0 + block]
        n = blk.shape[0]
        ng = (n + _BYTE_GROUP - 1) // _BYTE_GROUP
        base = np.concatenate([prev[None, :], blk[:-1]], axis=0)
        deltas = _zigzag8((blk.astype(np.int16) - base.astype(np.int16)) & 0xFF)
        for k in range(stride):
            lane = np.zeros(ng * _BYTE_GROUP, np.uint8)
            lane[:n] = deltas[:, k]
            header = bytearray((ng + 3) // 4)
            body = bytearray()
            for g in range(ng):
                grp = lane[g * _BYTE_GROUP : (g + 1) * _BYTE_GROUP]
                best = min((0, 2, 4, 8), key=lambda bb: _group_size(grp, bb))
                header[g // 4] |= {0: 0, 2: 1, 4: 2, 8: 3}[best] << ((g % 4) * 2)
                _encode_group(body, grp, best)
            out.extend(header)
            out.extend(body)
        prev = blk[-1].copy()

    tail = bytearray(max(_TAIL_MAX, stride))
    tail[-stride:] = v[0].tobytes()
    out.extend(tail)
    return bytes(out)


def decode_vertex_buffer(data: bytes, count: int, stride: int) -> np.ndarray:
    """Returns [count, stride] u8."""
    data = bytes(data)
    if not data or (data[0] & 0xF0) != (VERTEX_HEADER & 0xF0):
        raise ValueError(f"bad vertex codec header {data[:1].hex() if data else '<empty>'}")
    if data[0] != VERTEX_HEADER:
        raise ValueError(f"unsupported vertex codec version {data[0] & 0x0F}")
    block = _block_size(stride)
    out = np.zeros((count, stride), np.uint8)
    tail = max(_TAIL_MAX, stride)
    prev = np.frombuffer(data, np.uint8, stride, len(data) - stride).copy()
    pos = 1
    for b0 in range(0, count, block):
        n = min(block, count - b0)
        ng = (n + _BYTE_GROUP - 1) // _BYTE_GROUP
        deltas = np.zeros((ng * _BYTE_GROUP, stride), np.uint8)
        for k in range(stride):
            header = np.frombuffer(data, np.uint8, (ng + 3) // 4, pos)
            pos += (ng + 3) // 4
            for g in range(ng):
                bits = {0: 0, 1: 2, 2: 4, 3: 8}[(header[g // 4] >> ((g % 4) * 2)) & 3]
                vals, pos = _decode_group(data, pos, bits)
                deltas[g * _BYTE_GROUP : (g + 1) * _BYTE_GROUP, k] = vals
        # prefix-sum the unzigzagged deltas down the block (mod 256)
        d = _unzigzag8(deltas[:n]).astype(np.uint64)
        d[0] += prev.astype(np.uint64)
        vals = np.cumsum(d, axis=0).astype(np.uint8)
        out[b0 : b0 + n] = vals
        prev = vals[-1].copy()
    if pos > len(data) - tail:
        raise ValueError("vertex codec stream overruns tail")
    return out


# ------------------------------------------------------------- varint utils


def _vbyte_encode(out: bytearray, v: int):
    v = int(v)
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)


def _vbyte_decode(data: bytes, pos: int) -> tuple[int, int]:
    v = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, pos
        shift += 7


def _zigzag32(v: int) -> int:
    return (v << 1) ^ (v >> 31) if v >= 0 else ((-v) << 1) - 1


def _unzigzag32(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


# -------------------------------------------------------------- triangle v1


class _EdgeFifo:
    def __init__(self):
        self.data = [(-1, -1)] * 16
        self.offset = 0

    def push(self, a, b):
        self.data[self.offset & 15] = (a, b)
        self.offset += 1

    def find(self, a, b):
        for i in range(16):
            if self.data[(self.offset - 1 - i) & 15] == (a, b):
                return i
        return -1

    def get(self, i):
        return self.data[(self.offset - 1 - i) & 15]


class _VertexFifo:
    def __init__(self):
        self.data = [-1] * 16
        self.offset = 0

    def push(self, v, cond=True):
        if cond:
            self.data[self.offset & 15] = v
            self.offset += 1

    def find(self, v):
        for i in range(16):
            if self.data[(self.offset - 1 - i) & 15] == v:
                return i
        return -1

    def get(self, i):
        return self.data[(self.offset - 1 - i) & 15]


# codeaux table: (feb, fec) byte pairs for the edge-miss fast path.  These
# are the meshoptimizer v1 defaults; entries 14/15 are reserved (codes
# 0xfe/0xff carry an explicit aux byte instead), and since v1 embeds the
# table in the last 16 bytes of the stream, decoders accept any table.
_CODEAUX_TABLE = [0x00, 0x76, 0x87, 0x56, 0x67, 0x78, 0xA9, 0x86,
                  0x65, 0x89, 0x68, 0x98, 0x01, 0x69, 0x00, 0x00]


def encode_index_buffer(indices: np.ndarray) -> bytes:
    """indices: flat [3*tris] u32 triangle list.

    Mirrors decode_index_buffer exactly (same fifo disciplines, conditional
    pushes, last-delta codes); see that function for the wire format notes.
    Triangles whose leading edge hits the edge fifo are emitted in the
    matched rotation — decode restores each triangle up to a
    winding-preserving cyclic rotation (geometrically identical; see
    tests/test_meshopt.py::test_rotation_unobservable)."""
    idx = np.asarray(indices, np.uint32).reshape(-1, 3)
    codes = bytearray()
    aux = bytearray()
    edges, verts = _EdgeFifo(), _VertexFifo()
    next_v = 0
    last = 0
    tbl_index = {b: i for i, b in enumerate(_CODEAUX_TABLE[:14])}

    def enc_index(v):
        nonlocal last
        _vbyte_encode(aux, _zigzag32(int(v) - int(last)))
        last = int(v)

    for tri in idx:
        a, b, c = (int(x) for x in tri)
        # edge fifo search: most-recent entry first, rotations in order per
        # entry — matches upstream getEdgeFifo's priority
        rot = [(a, b, c), (b, c, a), (c, a, b)]
        fe, ra = -1, rot[0]
        for i in range(16):
            ent = edges.get(i)
            hit = next((r for r in rot if (r[0], r[1]) == ent), None)
            if hit is not None:
                fe, ra = i, hit
                break
        a, b, c = ra
        if fe >= 0:
            fc = verts.find(c)
            if c == next_v:
                codes.append((fe << 4) | 0)
                next_v += 1
                verts.push(c)
            elif 1 <= fc < 13:
                # vertex-fifo position encoded directly (1..12); the
                # referenced vertex is NOT re-pushed
                codes.append((fe << 4) | fc)
            elif c == last - 1:
                codes.append((fe << 4) | 13)  # fec - (fec ^ 3) = -1
                last = c
                verts.push(c)
            elif c == last + 1:
                codes.append((fe << 4) | 14)  # fec - (fec ^ 3) = +1
                last = c
                verts.push(c)
            else:
                codes.append((fe << 4) | 15)
                enc_index(c)
                verts.push(c)
            edges.push(c, b)
            edges.push(a, c)
        else:
            # no edge hit: a rides next/explicit, b and c ride (feb, fec).
            # Pushes interleave with the fifo lookups (a enters the fifo
            # before b's position is measured, etc.) — decode mirrors this.
            fea = 0 if a == next_v else 15
            if fea == 0:
                next_v += 1
            verts.push(a)
            fb = verts.find(b)
            if b == next_v:
                feb = 0
                next_v += 1
            elif 0 <= fb < 13:
                feb = fb + 1
            else:
                feb = 15
            verts.push(b, feb == 0 or feb == 15)
            fc = verts.find(c)
            if c == next_v:
                fec = 0
                next_v += 1
            elif 0 <= fc < 13:
                fec = fc + 1
            else:
                fec = 15
            verts.push(c, fec == 0 or fec == 15)
            auxbyte = (feb << 4) | fec
            if fea == 0 and auxbyte in tbl_index:
                codes.append(0xF0 | tbl_index[auxbyte])
            else:
                codes.append(0xFE if fea == 0 else 0xFF)
                aux.append(auxbyte)
            if fea == 15:
                enc_index(a)
            if feb == 15:
                enc_index(b)
            if fec == 15:
                enc_index(c)
            edges.push(b, a)
            edges.push(c, b)
            edges.push(a, c)

    out = bytearray([INDEX_HEADER])
    out.extend(codes)
    out.extend(aux)
    out.extend(bytes(_CODEAUX_TABLE))
    return bytes(out)


def decode_index_buffer(data: bytes, count: int) -> np.ndarray:
    """Returns flat [count] u32 (count = 3 * triangles).

    Follows the meshoptimizer v1 triangle wire format (consumed by the
    reference via EXT_meshopt_compression, scene.cpp:405-471): header byte
    0xE0|version; one code byte per triangle; a shared varint/aux data
    stream; the 16-byte codeaux table in the stream tail.  Per code byte
    (fe = high nibble, fec = low nibble):

      * fe < 15: edge-fifo hit at position fe giving (a, b).  fec 0 = c is
        `next` (incrementing); 1..12 = vertex-fifo position read directly
        (entry offset-1-fec), NOT re-pushed; 13/14 = c is last-1 / last+1
        (v1 only); 15 = explicit zigzag-varint delta vs `last`.
      * fe == 15: codes 0xF0..0xFD read (feb, fec) from the embedded
        codeaux table with a = next; 0xFE/0xFF read an explicit aux byte
        (0xFF additionally makes a explicit).  b and c decode like c above
        but with fifo positions biased by the interleaved a/b pushes.
    """
    data = bytes(data)
    if not data or (data[0] & 0xF0) != 0xE0:
        raise ValueError("bad triangle codec header")
    version = data[0] & 0x0F
    if version > 1:
        raise ValueError(f"unsupported triangle codec version {version}")
    fecmax = 13 if version >= 1 else 15
    n_tri = count // 3
    table = data[-16:]
    codes = data[1 : 1 + n_tri]
    pos = 1 + n_tri

    out = np.zeros(count, np.uint32)
    edges, verts = _EdgeFifo(), _VertexFifo()
    next_v = 0
    last = 0

    def dec_index():
        nonlocal pos, last
        d, pos = _vbyte_decode(data, pos)
        last = last + _unzigzag32(d)
        return last

    for t in range(n_tri):
        code = codes[t]
        if code < 0xF0:
            fe = code >> 4
            a, b = edges.get(fe)
            fec = code & 15
            if fec < fecmax:
                cf = verts.get(fec)
                c = next_v if fec == 0 else cf
                if fec == 0:
                    next_v += 1
                verts.push(c, fec == 0)
            else:
                if fec != 15:
                    c = last + (fec - (fec ^ 3))  # 13 -> last-1, 14 -> last+1
                    last = c
                else:
                    c = dec_index()
                verts.push(c)
            edges.push(c, b)
            edges.push(a, c)
        else:
            if code < 0xFE:
                auxbyte = table[code & 15]
                fea = 0
            else:
                auxbyte = data[pos]
                pos += 1
                fea = 0 if code == 0xFE else 15
                if auxbyte == 0:
                    next_v = 0  # explicit zero aux = index restart (v1)
            feb, fec = auxbyte >> 4, auxbyte & 15
            if fea == 0:
                a = next_v
                next_v += 1
            else:
                a = dec_index()
            verts.push(a)
            # feb/fec are 1-based fifo positions measured AFTER the
            # preceding pushes of this triangle (encoder interleaves)
            b = next_v if feb == 0 else verts.get(feb - 1)
            if feb == 0:
                next_v += 1
            elif feb == 15:
                b = dec_index()
            verts.push(b, feb == 0 or feb == 15)
            c = next_v if fec == 0 else verts.get(fec - 1)
            if fec == 0:
                next_v += 1
            elif fec == 15:
                c = dec_index()
            verts.push(c, fec == 0 or fec == 15)
            edges.push(b, a)
            edges.push(c, b)
            edges.push(a, c)
        out[3 * t : 3 * t + 3] = (a, b, c)
    return out


# -------------------------------------------------------- index sequence v1


def encode_index_sequence(indices: np.ndarray) -> bytes:
    """meshoptimizer index-sequence codec: each value is a vbyte whose low
    bit selects one of TWO running baselines; the rest is a zigzag delta
    against (and update of) that baseline — line strips with restart
    indices keep both streams short."""
    out = bytearray([SEQUENCE_HEADER])
    last = [0, 0]
    for v in np.asarray(indices, np.uint32):
        v = int(v)
        cur = 0 if abs(v - last[0]) <= abs(v - last[1]) else 1
        _vbyte_encode(out, (_zigzag32(v - last[cur]) << 1) | cur)
        last[cur] = v
    return bytes(out)


def decode_index_sequence(data: bytes, count: int) -> np.ndarray:
    data = bytes(data)
    if not data or (data[0] & 0xF0) != 0xD0:
        raise ValueError("bad index sequence header")
    if (data[0] & 0x0F) > 1:
        raise ValueError(f"unsupported sequence codec version {data[0] & 0x0F}")
    out = np.zeros(count, np.uint32)
    pos = 1
    last = [0, 0]
    for i in range(count):
        v, pos = _vbyte_decode(data, pos)
        cur = v & 1
        last[cur] = last[cur] + _unzigzag32(v >> 1)
        out[i] = last[cur]
    return out


# ------------------------------------------------------------------ filters


def decode_filter_oct(data: np.ndarray) -> np.ndarray:
    """Octahedral normal/tangent filter: [n, 4] i8 or i16 -> same shape,
    components renormalized as snorm (meshopt decodeFilterOct)."""
    a = np.asarray(data)
    assert a.ndim == 2 and a.shape[1] == 4 and a.dtype in (np.int8, np.int16)
    maxi = float(np.iinfo(a.dtype).max)
    one = a[:, 2].astype(np.float32) / maxi  # z channel carries the K scale
    x = a[:, 0].astype(np.float32) / maxi
    y = a[:, 1].astype(np.float32) / maxi
    z = one - np.abs(x) - np.abs(y)
    t = np.maximum(-z, 0.0)
    x -= np.sign(x) * t
    y -= np.sign(y) * t
    n = np.stack([x, y, z], axis=1)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-20)
    out = a.copy()
    out[:, :3] = np.clip(np.rint(n * maxi), -maxi - 1, maxi).astype(a.dtype)
    return out


def decode_filter_quat(data: np.ndarray) -> np.ndarray:
    """Quaternion filter: [n, 4] i16 -> snorm16 quaternion (wxyz order per
    stored max-component index in the low 2 bits of component 3)."""
    a = np.asarray(data, np.int16)
    assert a.ndim == 2 and a.shape[1] == 4
    scale = np.float32(1.0 / (np.sqrt(2.0) * 32767.0))
    x = a[:, 0].astype(np.float32) * scale * 2
    y = a[:, 1].astype(np.float32) * scale * 2
    z = a[:, 2].astype(np.float32) * scale * 2
    mc = (a[:, 3] & 3).astype(np.int32)
    ww = np.maximum(1.0 - x * x - y * y - z * z, 0.0)
    w = np.sqrt(ww)
    comps = np.stack([x, y, z, w], axis=1)
    out = np.zeros((a.shape[0], 4), np.float32)
    for m in range(4):
        sel = mc == m
        order = [(m + 1 + k) % 4 for k in range(3)]
        out[sel, order[0]] = comps[sel, 0]
        out[sel, order[1]] = comps[sel, 1]
        out[sel, order[2]] = comps[sel, 2]
        out[sel, m] = comps[sel, 3]
    return np.clip(np.rint(out * 32767.0), -32768, 32767).astype(np.int16)


def decode_filter_exp(data: np.ndarray) -> np.ndarray:
    """Exponential filter: u32 words (8-bit exponent | 24-bit signed
    mantissa) -> f32 mantissa * 2^exponent."""
    a = np.asarray(data, np.uint32)
    exp = (a >> 24).astype(np.int32).astype(np.int8).astype(np.int32)
    man = (a & 0xFFFFFF).astype(np.int32)
    man = np.where(man >= 1 << 23, man - (1 << 24), man)
    return (man.astype(np.float64) * np.exp2(exp.astype(np.float64))).astype(np.float32)


def decode_buffer_view(data: bytes, mode: str, count: int, stride: int,
                       filt: str = "NONE") -> bytes:
    """EXT_meshopt_compression bufferView decode: codec by mode, then
    filter.  Returns the decompressed bufferView bytes."""
    if mode == "ATTRIBUTES":
        out = decode_vertex_buffer(data, count, stride)
        if filt == "OCTAHEDRAL":
            dt = np.int8 if stride == 4 else np.int16
            out = decode_filter_oct(out.view(dt).reshape(count, 4)).view(np.uint8).reshape(count, stride)
        elif filt == "QUATERNION":
            out = decode_filter_quat(out.view(np.int16).reshape(count, 4)).view(np.uint8).reshape(count, stride)
        elif filt == "EXPONENTIAL":
            w = out.view(np.uint32).reshape(count, stride // 4)
            out = decode_filter_exp(w).view(np.uint8).reshape(count, stride)
        return out.tobytes()
    if mode == "TRIANGLES":
        out = decode_index_buffer(data, count)
    elif mode == "INDICES":
        out = decode_index_sequence(data, count)
    else:
        raise ValueError(f"unknown meshopt mode {mode!r}")
    if stride == 2:
        return out.astype(np.uint16).tobytes()
    return out.astype(np.uint32).tobytes()
