"""The part of HDF5 that the system's trajectory files use, in numpy and the
standard library (`struct`, `zlib`), so that the port reads and writes them
where h5py is not installed.

    with h5.File(path, "w") as f:
        f.create_dataset("traj_per_file", data=1)
        f.create_dataset("traj0/images", data=frames)   # groups made on the way
    with h5.File(path, "r") as f:
        n = int(f["traj_per_file"][()])
        if "traj0/images" in f:
            frames = f["traj0/images"][()]
        names = list(f["traj0"])                        # a group's keys, sorted

Reads what h5py writes by default (libver 'earliest'): superblock version 0
or 1; version 1 object headers with continuation blocks; groups stored as
symbol tables (a version 1 B-tree of type 0, symbol table nodes and a local
heap); dataspace messages version 1 and 2, scalar or simple; fixed-point
and floating-point datatypes, little-endian, of 1, 2, 4 or 8 bytes; data
layout message version 3, compact, contiguous or chunked (a version 1
B-tree of type 1) with the filters deflate (1) and shuffle (2). Anything
else raises ValueError naming what it found, so nothing is read wrongly
without a word.

Writes superblock version 0, version 1 object headers, symbol-table groups
and contiguous datasets of those datatypes, scalar or N-d. A file is
written when it is closed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_UNDEF = 0xFFFFFFFFFFFFFFFF  # the undefined address
_LEAF_K, _NODE_K = 4, 16  # group B-tree K values that h5py's files carry

# object header message types
_MSG_NIL, _MSG_DATASPACE, _MSG_DATATYPE, _MSG_LAYOUT = 0x0, 0x1, 0x3, 0x8
_MSG_FILTERS, _MSG_CONTINUATION, _MSG_SYMBOL_TABLE = 0xB, 0x10, 0x11
# messages that do not change how the data's bytes read (fill value, name
# and time stamps, attributes, object reference count, B-tree 'K' values)
_IGNORED = {0x4, 0x5, 0xC, 0xD, 0xE, 0x12, 0x13, 0x16}
_FILTER_DEFLATE, _FILTER_SHUFFLE = 1, 2


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _Reader:
    """Random access to the file's bytes; a short read raises."""

    def __init__(self, fh):
        self.fh = fh

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(addr)
        data = self.fh.read(n)
        if len(data) != n:
            raise ValueError(f"truncated HDF5 file: {n} bytes at {addr} reach past its end")
        return data


def _superblock(r: _Reader) -> int:
    """The root group's object header address."""
    head = r.read(0, 24)
    if head[:8] != _SIGNATURE:
        raise ValueError("not an HDF5 file (no signature at offset 0)")
    version = head[8]
    if version not in (0, 1):
        raise ValueError(f"superblock version {version}: only versions 0 and 1 are read")
    sizeof_addr, sizeof_len = head[13], head[14]
    if (sizeof_addr, sizeof_len) != (8, 8):
        raise ValueError(f"offsets of {sizeof_addr} and lengths of {sizeof_len} bytes: "
                         "only 8-byte ones are read")
    pos = 24 + (4 if version == 1 else 0)
    base = struct.unpack_from("<Q", r.read(pos, 8))[0]
    if base != 0:
        raise ValueError(f"base address {base}: only 0 is read")
    root_entry = r.read(pos + 32, 40)
    return struct.unpack_from("<Q", root_entry, 8)[0]


def _messages(r: _Reader, addr: int):
    """(type, flags, data) of every message of a version 1 object header,
    continuation blocks included."""
    prefix = r.read(addr, 16)
    version = prefix[0]
    if prefix[:4] == b"OHDR" or version != 1:
        raise ValueError(f"object header version {2 if prefix[:4] == b'OHDR' else version} "
                         f"at {addr}: only version 1 is read")
    n_msgs, _, size = struct.unpack_from("<HII", prefix, 2)
    blocks, out = [(addr + 16, size)], []
    while blocks:
        start, length = blocks.pop(0)
        block, pos = r.read(start, length), 0
        while pos + 8 <= length and len(out) < n_msgs:
            kind, msize, flags = struct.unpack_from("<HHB", block, pos)
            data = block[pos + 8:pos + 8 + msize]
            pos += 8 + msize
            if kind == _MSG_CONTINUATION:
                blocks.append(struct.unpack_from("<QQ", data))
            elif flags & 0x2:
                raise ValueError(f"shared object header message of type {kind:#x}")
            out.append((kind, flags, data))
    return out


def _dataspace(data: bytes):
    version, rank, flags = data[0], data[1], data[2]
    if version == 1:
        pos = 8
    elif version == 2:
        kind = data[3]
        if kind == 2:
            raise ValueError("null dataspace (an empty dataset)")
        if kind not in (0, 1):
            raise ValueError(f"dataspace type {kind}")
        pos = 4
    else:
        raise ValueError(f"dataspace message version {version}")
    if flags & 0x2:
        raise ValueError("dataspace with a permutation index")
    return tuple(struct.unpack_from(f"<{rank}Q", data, pos))


_FLOAT_BITS = {2: (15, 10, 5, 0, 10, 15), 4: (31, 23, 8, 0, 23, 127),
               8: (63, 52, 11, 0, 52, 1023)}  # sign, exponent, mantissa fields, bias


def _datatype(data: bytes) -> np.dtype:
    cls, version = data[0] & 0x0F, data[0] >> 4
    bits = data[1] | data[2] << 8 | data[3] << 16
    (size,) = struct.unpack_from("<I", data, 4)
    if version != 1:
        raise ValueError(f"datatype message version {version}")
    if cls not in (0, 1):
        names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enum", 9: "variable-length", 10: "array"}
        raise ValueError(f"datatype class {cls} ({names.get(cls, 'unknown')}): only "
                         "fixed-point (0) and floating-point (1) are read")
    if bits & 0x1 or (cls == 1 and bits & 0x40):
        raise ValueError(f"datatype class {cls} of {size} bytes is big-endian")
    if size not in (1, 2, 4, 8):
        raise ValueError(f"datatype class {cls} of {size} bytes")
    offset, precision = struct.unpack_from("<HH", data, 8)
    if (offset, precision) != (0, 8 * size):
        raise ValueError(f"datatype class {cls} with bit offset {offset} and precision "
                         f"{precision} in {size} bytes")
    if cls == 0:
        return np.dtype(f"<{'i' if bits & 0x8 else 'u'}{size}")
    if size == 1:
        raise ValueError("floating-point datatype of 1 byte")
    layout = (bits >> 8 & 0xFF, data[12], data[13], data[14], data[15],
              struct.unpack_from("<I", data, 16)[0])
    if layout != _FLOAT_BITS[size]:
        raise ValueError(f"floating-point datatype of {size} bytes with the IEEE "
                         f"layout differing: {layout}")
    return np.dtype(f"<f{size}")


def _filters(data: bytes):
    """[(filter id, client data)] of a filter pipeline message."""
    version, n = data[0], data[1]
    if version not in (1, 2):
        raise ValueError(f"filter pipeline message version {version}")
    pos, out = (8 if version == 1 else 2), []
    for _ in range(n):
        fid = struct.unpack_from("<H", data, pos)[0]
        if version == 1 or fid >= 256:
            name_len = struct.unpack_from("<H", data, pos + 2)[0]
            _, n_cd = struct.unpack_from("<HH", data, pos + 4)
            pos += 8
        else:
            name_len = 0
            _, n_cd = struct.unpack_from("<HH", data, pos + 2)
            pos += 6
        pos += _pad8(name_len) if version == 1 else name_len
        client = struct.unpack_from(f"<{n_cd}I", data, pos)
        pos += 4 * n_cd + (4 if version == 1 and n_cd % 2 else 0)
        if fid not in (_FILTER_DEFLATE, _FILTER_SHUFFLE):
            raise ValueError(f"filter {fid}: only deflate (1) and shuffle (2) are read")
        out.append((fid, client))
    return out


def _unshuffle(raw: bytes, itemsize: int) -> bytes:
    n = len(raw) // itemsize
    body = np.frombuffer(raw, np.uint8, n * itemsize).reshape(itemsize, n).T
    return body.tobytes() + raw[n * itemsize:]


class Dataset:
    """A dataset of an open file; `ds[()]` reads it whole."""

    def __init__(self, r: _Reader, msgs):
        self._r = r
        self.shape, self.dtype, layout, self._filters = None, None, None, []
        for kind, _, data in msgs:
            if kind == _MSG_DATASPACE:
                self.shape = _dataspace(data)
            elif kind == _MSG_DATATYPE:
                self.dtype = _datatype(data)
            elif kind == _MSG_LAYOUT:
                layout = data
            elif kind == _MSG_FILTERS:
                self._filters = _filters(data)
            elif kind not in _IGNORED | {_MSG_NIL, _MSG_CONTINUATION}:
                raise ValueError(f"dataset object header message of type {kind:#x}")
        if self.shape is None or self.dtype is None or layout is None:
            raise ValueError("dataset without a dataspace, datatype or layout message")
        if layout[0] != 3:
            raise ValueError(f"data layout message version {layout[0]}: only 3 is read")
        self._layout = layout

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __getitem__(self, key):
        if key != () and key is not Ellipsis:
            raise ValueError("only ds[()] (the whole dataset) is read")
        arr = self._read()
        return arr[()] if arr.ndim == 0 else arr

    def _read(self) -> np.ndarray:
        layout, nbytes = self._layout, self.size * self.dtype.itemsize
        cls = layout[1]
        if cls != 2 and self._filters:
            raise ValueError(f"filters on a dataset of layout class {cls}")
        if nbytes == 0:
            return np.zeros(self.shape, self.dtype)
        if cls == 0:  # compact: the bytes are in the message
            (size,) = struct.unpack_from("<H", layout, 2)
            raw = layout[4:4 + size]
        elif cls == 1:
            addr, size = struct.unpack_from("<QQ", layout, 2)
            if addr == _UNDEF:
                raise ValueError("contiguous dataset whose data was never written")
            raw = self._r.read(addr, size)
        elif cls == 2:
            return self._read_chunked()
        else:
            raise ValueError(f"layout class {cls}: only compact (0), contiguous (1) and "
                             "chunked (2) are read")
        if len(raw) < nbytes:
            raise ValueError(f"dataset of {nbytes} bytes stores {len(raw)}")
        return np.frombuffer(raw, self.dtype, self.size).reshape(self.shape).copy()

    def _read_chunked(self) -> np.ndarray:
        layout, rank = self._layout, len(self.shape)
        ndims = layout[2]  # the dataset's rank + 1 (the element's bytes)
        (btree,) = struct.unpack_from("<Q", layout, 3)
        chunk = struct.unpack_from(f"<{ndims}I", layout, 11)[:rank]
        if ndims != rank + 1:
            raise ValueError(f"chunked layout of {ndims} dimensions for rank {rank}")
        if btree == _UNDEF:
            raise ValueError("chunked dataset whose data was never written")
        out = np.zeros(self.shape, self.dtype)
        itemsize = self.dtype.itemsize
        chunk_bytes = int(np.prod(chunk, dtype=np.int64)) * itemsize
        for size, mask, offsets, addr in self._chunks(btree, ndims):
            raw = self._r.read(addr, size)
            for i, (fid, client) in reversed(list(enumerate(self._filters))):
                if mask >> i & 1:
                    continue
                raw = zlib.decompress(raw) if fid == _FILTER_DEFLATE else _unshuffle(
                    raw, client[0] if client else itemsize)
            if len(raw) != chunk_bytes:
                raise ValueError(f"chunk of {len(raw)} bytes, expected {chunk_bytes}")
            block = np.frombuffer(raw, self.dtype).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offsets, chunk, self.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _chunks(self, addr: int, ndims: int):
        """(stored size, filter mask, element offsets, address) of every chunk
        under a version 1 B-tree node of type 1."""
        head = self._r.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise ValueError(f"expected a B-tree node of type 1 at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        key_size = 8 + 8 * ndims
        body = self._r.read(addr + 24, used * (key_size + 8) + key_size)
        for i in range(used):
            pos = i * (key_size + 8)
            size, mask = struct.unpack_from("<II", body, pos)
            offsets = struct.unpack_from(f"<{ndims}Q", body, pos + 8)[:-1]
            (child,) = struct.unpack_from("<Q", body, pos + key_size)
            if level == 0:
                yield size, mask, offsets, child
            else:
                yield from self._chunks(child, ndims)


class Group:
    """A group of an open file: `name in g`, `g[name]` (a path of names
    separated by '/'), and iteration over its keys in name order."""

    def __init__(self, r: _Reader, msgs):
        self._r = r
        table = [data for kind, _, data in msgs if kind == _MSG_SYMBOL_TABLE]
        if not table:
            kinds = sorted({kind for kind, _, _ in msgs})
            raise ValueError("group without a symbol table message (a version 2 group "
                             f"of link messages?); message types {kinds}")
        btree, heap = struct.unpack_from("<QQ", table[0])
        self._names = self._heap(heap)
        self._links = {}
        self._walk(btree)

    def _heap(self, addr: int) -> bytes:
        head = self._r.read(addr, 32)
        if head[:4] != b"HEAP" or head[4] != 0:
            raise ValueError(f"expected a local heap of version 0 at {addr}")
        size, _, data_addr = struct.unpack_from("<QQQ", head, 8)
        return self._r.read(data_addr, size)

    def _name(self, offset: int) -> str:
        end = self._names.index(b"\0", offset)
        return self._names[offset:end].decode("utf-8")

    def _walk(self, addr: int):
        head = self._r.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise ValueError(f"expected a B-tree node of type 0 at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self._r.read(addr + 24, used * 16 + 8)
        for i in range(used):
            (child,) = struct.unpack_from("<Q", body, 8 + 16 * i)
            if level:
                self._walk(child)
                continue
            snod = self._r.read(child, 8)
            if snod[:4] != b"SNOD" or snod[4] != 1:
                raise ValueError(f"expected a symbol table node of version 1 at {child}")
            n = struct.unpack_from("<H", snod, 6)[0]
            entries = self._r.read(child + 8, 40 * n)
            for j in range(n):
                name_off, header = struct.unpack_from("<QQ", entries, 40 * j)
                self._links[self._name(name_off)] = header

    def _get(self, name: str):
        obj = self
        for part in (p for p in name.split("/") if p):
            if not isinstance(obj, Group) or part not in obj._links:
                return None
            obj = _open(obj._r, obj._links[part])
        return obj

    def __contains__(self, name: str) -> bool:
        return self._get(name) is not None

    def __getitem__(self, name: str):
        obj = self._get(name)
        if obj is None:
            raise KeyError(f"no object {name!r} in the group")
        return obj

    def keys(self):
        return sorted(self._links)

    def __iter__(self):
        return iter(self.keys())


def _open(r: _Reader, addr: int):
    msgs = _messages(r, addr)
    kinds = {kind for kind, _, _ in msgs}
    if _MSG_SYMBOL_TABLE in kinds:
        return Group(r, msgs)
    if kinds & {0x2, 0x6, 0xA}:  # link info, link, group info
        raise ValueError(f"group stored as link messages (types {sorted(kinds)}): only "
                         "symbol-table groups are read")
    return Dataset(r, msgs)


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _datatype_message(dtype: np.dtype) -> bytes:
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        head = struct.pack("<BBBBI", 0x10, 0x8 if dtype.kind == "i" else 0, 0, 0, size)
        return head + struct.pack("<HH", 0, 8 * size)
    if dtype.kind == "f" and size in _FLOAT_BITS:
        sign, e_loc, e_size, m_loc, m_size, bias = _FLOAT_BITS[size]
        head = struct.pack("<BBBBI", 0x11, 0x20, sign, 0, size)
        return head + struct.pack("<HHBBBBI", 0, 8 * size, e_loc, e_size, m_loc, m_size, bias)
    raise ValueError(f"h5.File writes integers and floats of 1 to 8 bytes, not {dtype}")


class _Layout:
    """Byte layout of the file being written: objects appended at 8-byte
    aligned addresses, their bytes filled in when known."""

    def __init__(self, start: int):
        self.parts, self.end = [], start

    def alloc(self, n: int) -> int:
        addr = self.end
        self.end += _pad8(n)
        return addr

    def put(self, addr: int, data: bytes):
        self.parts.append((addr, data))


def _object_header(messages) -> bytes:
    body = b"".join(struct.pack("<HHB3x", kind, _pad8(len(data)), 0)
                    + data.ljust(_pad8(len(data)), b"\0") for kind, data in messages)
    return struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body


def _write_dataset(lay: _Layout, arr: np.ndarray) -> int:
    space = struct.pack("<BBBB4x", 1, arr.ndim, 0, 0) + b"".join(
        struct.pack("<Q", d) for d in arr.shape)
    data = np.ascontiguousarray(arr).tobytes()
    data_addr = lay.alloc(len(data)) if data else _UNDEF
    layout = struct.pack("<BBQQ", 3, 1, data_addr, len(data))
    header = _object_header([(_MSG_DATASPACE, space),
                             (_MSG_DATATYPE, _datatype_message(arr.dtype)),
                             (_MSG_LAYOUT, layout)])
    addr = lay.alloc(len(header))
    lay.put(addr, header)
    if data:
        lay.put(data_addr, data)
    return addr


def _write_group(lay: _Layout, members: dict):
    """(object header address, B-tree address, heap address) of a group."""
    names = sorted(members)
    heap_data, offsets = bytearray(8), []  # offset 0: the empty name
    for name in names:
        offsets.append(len(heap_data))
        heap_data += name.encode("utf-8").ljust(_pad8(len(name.encode("utf-8")) + 1), b"\0")
    heap_addr = lay.alloc(32)
    heap_data_addr = lay.alloc(len(heap_data))
    lay.put(heap_addr, b"HEAP" + struct.pack("<B3xQQQ", 0, len(heap_data), 1,
                                             heap_data_addr))
    lay.put(heap_data_addr, bytes(heap_data))

    entries = []
    for name, off in zip(names, offsets):
        obj = members[name]
        if isinstance(obj, dict):
            header, btree, heap = _write_group(lay, obj)
            entries.append(struct.pack("<QQI4xQQ", off, header, 1, btree, heap))
        else:
            entries.append(struct.pack("<QQI4x16x", off, _write_dataset(lay, obj), 0))
    per_node = 2 * _LEAF_K
    nodes = [entries[i:i + per_node] for i in range(0, len(entries), per_node)]
    if len(nodes) > 2 * _NODE_K:
        raise ValueError(f"h5.File writes groups of up to {2 * _NODE_K * per_node} members")
    snods = []
    for node in nodes:
        addr = lay.alloc(8 + 40 * per_node)  # read whole by HDF5
        lay.put(addr, b"SNOD" + struct.pack("<BxH", 1, len(node)) + b"".join(node).ljust(
            40 * per_node, b"\0"))
        snods.append(addr)
    # keys: the empty name, then the last name of each node
    keys = [0] + [offsets[min((i + 1) * per_node, len(names)) - 1]
                  for i in range(len(nodes))]
    body = struct.pack("<Q", keys[0]) + b"".join(
        struct.pack("<QQ", child, key) for child, key in zip(snods, keys[1:]))
    btree_size = 24 + 8 * (2 * _NODE_K + 1) + 8 * 2 * _NODE_K
    btree = lay.alloc(btree_size)
    lay.put(btree, (b"TREE" + struct.pack("<BBHQQ", 0, 0, len(nodes), _UNDEF, _UNDEF)
                    + body).ljust(btree_size, b"\0"))
    header = _object_header([(_MSG_SYMBOL_TABLE, struct.pack("<QQ", btree, heap_addr))])
    addr = lay.alloc(len(header))
    lay.put(addr, header)
    return addr, btree, heap_addr


def _write_file(path, members: dict):
    lay = _Layout(96)
    root, btree, heap = _write_group(lay, members)
    superblock = (_SIGNATURE + struct.pack("<8B", 0, 0, 0, 0, 0, 8, 8, 0)
                  + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                  + struct.pack("<QQQQ", 0, _UNDEF, lay.end, _UNDEF)
                  + struct.pack("<QQI4xQQ", 0, root, 1, btree, heap))
    buf = bytearray(lay.end)
    buf[:len(superblock)] = superblock
    for addr, data in lay.parts:
        buf[addr:addr + len(data)] = data
    with open(path, "wb") as f:
        f.write(buf)


class File:
    """An HDF5 file opened for reading ('r') or writing ('w', written when
    closed); a context manager. Reading: `name in f`, `f[name]` and
    iteration over the root group's keys. Writing: `create_dataset`."""

    def __init__(self, path, mode: str = "r"):
        if mode not in ("r", "w"):
            raise ValueError(f"h5.File mode {mode!r}: only 'r' and 'w'")
        self.path, self.mode = path, mode
        if mode == "r":
            self._fh = open(path, "rb")
            try:
                r = _Reader(self._fh)
                self._root = _open(r, _superblock(r))
            except Exception:
                self._fh.close()
                raise
        else:
            self._fh, self._members = None, {}

    def create_dataset(self, name: str, data):
        if self.mode != "w":
            raise ValueError("create_dataset on a file opened for reading")
        arr = np.asarray(data)
        _datatype_message(arr.dtype)  # raises for a type outside the subset
        *groups, leaf = [p for p in name.split("/") if p]
        node = self._members
        for g in groups:
            node = node.setdefault(g, {})
            if not isinstance(node, dict):
                raise ValueError(f"{name!r}: {g!r} is a dataset")
        if leaf in node:
            raise ValueError(f"{name!r} exists")
        node[leaf] = arr

    def close(self):
        if self.mode == "w" and self._members is not None:
            members, self._members = self._members, None
            _write_file(self.path, members)
        elif self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if exc[0] is not None and self.mode == "w":
            self._members = None  # write nothing after a failure
        self.close()

    def _reading(self) -> Group:
        if self.mode != "r" or self._fh is None:
            raise ValueError("the file is not open for reading")
        return self._root

    def __contains__(self, name):
        return name in self._reading()

    def __getitem__(self, name):
        return self._reading()[name]

    def __iter__(self):
        return iter(self._reading())
