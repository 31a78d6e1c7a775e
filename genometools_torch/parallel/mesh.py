"""A mesh of torch devices, its collectives and a stable multi-column sort.

Counterpart of ``jax.sharding.Mesh`` (one axis, "shard") and of the
``jax.lax`` collectives that ``genometools_tpu/parallel`` calls inside
``jax.shard_map``. The reference runs one program on every device under
a single controller; here one process holds every shard's tensors, each
on its shard's device, and loops over the shards. A sharded array is a
list of per-shard tensors (block m on ``mesh.devices[m]``), and a
collective is a set of explicit copies between shards: peer copies
between distinct cards, none at all where two shards share a device.

A mesh may list one device several times. Eight shards on one card run
the whole algorithm, its exchanges included, as the reference's tests
run on eight virtual CPU devices; the same code runs unchanged on
distinct cards.
"""

from __future__ import annotations

import torch

from ..device import resolve_device


class Mesh:
    """An ordered list of devices, one shard each (repeats allowed)."""

    def __init__(self, devices):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def shard(self, x: torch.Tensor) -> list:
        """x (length a multiple of the mesh size) as its per-shard
        blocks."""
        C = x.shape[0] // self.size
        if C * self.size != x.shape[0]:
            raise ValueError(f"length {x.shape[0]} is not a multiple of "
                             f"the mesh size {self.size}")
        return [x[m * C:(m + 1) * C].to(d) for m, d in
                enumerate(self.devices)]

    def replicate(self, x: torch.Tensor) -> list:
        """x on every shard's device (one tensor per device)."""
        copies = {}
        return [copies.setdefault(d, x.to(d)) for d in self.devices]


def make_mesh(n_devices: int | None = None, device="cuda") -> Mesh:
    """The first n_devices distinct cards (all of them by default), as
    the reference takes jax.devices()[:n]; on the CPU, n_devices shards
    of the CPU (one by default)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * (n_devices or 1))
    cards = [torch.device("cuda", i)
             for i in range(torch.cuda.device_count())]
    return Mesh(cards[:n_devices or len(cards)])


def virtual_mesh(n_shards: int, device="cuda") -> Mesh:
    """n_shards shards dealt over the attached cards in turn, several to
    a card where there are fewer cards than shards (the CPU: all on
    it)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return Mesh([dev] * n_shards)
    ncard = torch.cuda.device_count()
    return Mesh([torch.device("cuda", i % ncard) for i in range(n_shards)])


def pow2_floor(n: int) -> int:
    return 1 << (max(n, 1).bit_length() - 1)


# ---------------------------------------------------------------------------
# collectives over per-shard lists (the jax.lax names)
# ---------------------------------------------------------------------------

def axis_index(mesh: Mesh) -> list:
    """Each shard's index, as a 0-d int64 tensor on its device."""
    return [torch.tensor(m, device=d) for m, d in enumerate(mesh.devices)]


def ppermute(blocks: list, perm) -> list:
    """out[dst] = blocks[src] for each (src, dst) in perm; a shard that
    receives nothing gets zeros (jax.lax.ppermute)."""
    out = [None] * len(blocks)
    for src, dst in perm:
        out[dst] = blocks[src].to(blocks[dst].device, non_blocking=True)
    return [torch.zeros_like(b) if o is None else o
            for o, b in zip(out, blocks)]


def all_to_all(blocks: list) -> list:
    """Tiled all_to_all over axis 0 (jax.lax.all_to_all(x, axis, 0, 0,
    tiled=True)): each block is P equal chunks, chunk j of shard i goes
    to shard j, and shard j's result is its chunks in source order."""
    P = len(blocks)
    chunks = [b.tensor_split(P) for b in blocks]
    return [torch.cat([chunks[i][j].to(blocks[j].device, non_blocking=True)
                       for i in range(P)]) for j in range(P)]


def all_gather(xs: list) -> list:
    """The stack of every shard's x, on every shard."""
    return [torch.stack([x.to(d.device, non_blocking=True) for x in xs])
            for d in xs]


def psum(xs: list) -> list:
    """The sum of every shard's x, on every shard."""
    dev0 = xs[0].device
    total = xs[0].clone()
    for x in xs[1:]:
        total += x.to(dev0, non_blocking=True)
    return [total.to(x.device) for x in xs]


def pmax(xs: list) -> list:
    dev0 = xs[0].device
    total = torch.stack([x.to(dev0) for x in xs]).amax(0)
    return [total.to(x.device) for x in xs]


def gather(blocks: list) -> torch.Tensor:
    """A sharded array whole, on the first shard's device."""
    dev0 = blocks[0].device
    return torch.cat([b.to(dev0) for b in blocks])


# ---------------------------------------------------------------------------
# stable multi-column sort (jax.lax.sort(tuple, num_keys=...))
# ---------------------------------------------------------------------------

def _narrow(word: torch.Tensor, bits: int) -> torch.Tensor:
    """A non-negative word of `bits` bits in the narrowest signed type
    that holds it: a radix sort makes one pass a byte of its type."""
    for dt, top in ((torch.int8, 7), (torch.int16, 15), (torch.int32, 31)):
        if bits <= top:
            return word.to(dt)
    return word


def bucket_order(d: torch.Tensor, nbuckets: int):
    """(stable order, sorted d, start of each bucket 0..nbuckets) of
    bucket ids d in [0, nbuckets)."""
    order = torch.argsort(_narrow(d, (nbuckets - 1).bit_length()),
                          stable=True)
    d_s = d[order]
    starts = torch.searchsorted(d_s, torch.arange(nbuckets + 1,
                                                  device=d.device))
    return order, d_s, starts


def lexsort_order(keys: list) -> torch.Tensor:
    """Stable order (int64) of rows sorted by keys, the first key most
    significant. Keys are offset by their minimum and packed, from the
    least significant, into as few int64 words as their ranges allow,
    each word in the narrowest type that holds it; each word is one
    stable sort, the least significant first."""
    n = keys[0].shape[0]
    dev = keys[0].device
    keys = [k.to(torch.int64) if k.dtype != torch.int64 else k
            for k in keys]
    if n == 0:
        return torch.zeros(0, dtype=torch.int64, device=dev)
    lohi = torch.stack([torch.stack(torch.aminmax(k)) for k in keys])
    bounds = lohi.tolist()
    words, word, bits = [], None, 0
    for k, (lo, hi) in zip(reversed(keys), reversed(bounds)):
        width = (hi - lo).bit_length()
        if width == 0:
            continue                          # a constant key orders nothing
        if width > 63:
            if word is not None:
                words.append(_narrow(word, bits))
            words.append(k)                   # sorts as it is
            word, bits = None, 0
            continue
        if word is not None and bits + width > 63:
            words.append(_narrow(word, bits))
            word, bits = None, 0
        part = k - lo if lo else k
        word = part if word is None else word | (part << bits)
        bits += width
    if word is not None:
        words.append(_narrow(word, bits))
    order = None
    for w in words:                           # least significant first
        if order is None:
            order = torch.argsort(w, stable=True)
        else:
            order = order[torch.argsort(w[order], stable=True)]
    if order is None:
        return torch.arange(n, device=dev)
    return order


def lexsort(cols: list, num_keys: int) -> list:
    """cols sorted together by their first num_keys columns, stably."""
    order = lexsort_order(cols[:num_keys])
    return [c[order] for c in cols]
