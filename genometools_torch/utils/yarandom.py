"""Deterministic RNG matching the reference's yarandom generator.

The port's copy of ``genometools_tpu/utils/yarandom.py`` (JAX-free
host code; the port imports nothing of the reference package).

Capability equivalent of src/core/yarandom.c (Knuth Vol.2 additive
generator, n=55, k=20, m=2^32; constants from CRC 18th ed. p.622) and
the gt_rand_* helpers from src/core/mathsupport.c.  Needed to
reproduce `gt -seed N seqmutate` outputs bit-exactly (the seed_extend
JKD test inputs are built that way)."""

from __future__ import annotations

_MASK = 0xFFFFFFFF
_RAND_MAX = 0x7FFFFFFF

_A_SOURCE = [
    0o35340171546, 0o10401501101, 0o22364657325, 0o24130436022,
    0o02167303062, 0o37570375137, 0o37210607110, 0o16272055420,
    0o23011770546, 0o17143426366, 0o14753657433, 0o21657231332,
    0o23553406142, 0o04236526362, 0o10365611275, 0o07117336710,
    0o11051276551, 0o02362132524, 0o01011540233, 0o12162531646,
    0o07056762337, 0o06631245521, 0o14164542224, 0o32633236305,
    0o23342700176, 0o02433062234, 0o15257225043, 0o26762051606,
    0o00742573230, 0o05366042132, 0o12126416411, 0o00520471171,
    0o00725646277, 0o20116577576, 0o25765742604, 0o07633473735,
    0o15674255275, 0o17555634041, 0o06503154145, 0o21576344247,
    0o14577627653, 0o02707523333, 0o34146376720, 0o30060227734,
    0o13765414060, 0o36072251540, 0o07255221037, 0o24364674123,
    0o06200353166, 0o10126373326, 0o15664104320, 0o16401041535,
    0o16215305520, 0o33115351014, 0o17411670323,
]


class YaRandom:
    """ref: yarandom.c gt_ya_rand_init / gt_ya_random."""

    def __init__(self, seed: int):
        a = [v & _MASK for v in _A_SOURCE]
        seed &= _MASK
        a[0] = (a[0] + seed) & _MASK
        for i in range(1, 55):
            seed = (a[i - 1] * 1001 + seed * 999) & _MASK
            a[i] = (a[i] + seed) & _MASK
        self.a = a
        self.i1 = a[0] % 55
        self.i2 = (self.i1 + 0o24) % 55

    def _next(self) -> int:
        ret = (self.a[self.i1] + self.a[self.i2]) & _MASK
        self.a[self.i1] = ret
        self.i1 = (self.i1 + 1) % 55
        self.i2 = (self.i2 + 1) % 55
        return ret

    def random(self) -> int:
        """ref: yarandom.h random() macro."""
        return self._next() & _RAND_MAX

    def rand_0_to_1(self) -> float:
        """ref: mathsupport.c:103 gt_rand_0_to_1."""
        return self.random() / _RAND_MAX

    def rand_max(self, maximal_value: int) -> int:
        """ref: mathsupport.c:85 gt_rand_max."""
        return int(self.random() / (_RAND_MAX + 1) * (maximal_value + 1))


def mutate_seq(seq: str, rng: YaRandom, rate: int,
               chars: str = "acgt") -> str:
    """ref: extended/mutate.c mutate_seq: per position, with
    probability rate/100 mutate — 80% substitution, 10% insertion,
    10% deletion; new characters are random non-wildcards keeping
    the original case."""
    prob = rate / 100.0
    out = []
    i, n = 0, len(seq)
    while i < n:
        was_upper = seq[i].isupper()
        if rng.rand_0_to_1() <= prob:
            p = rng.rand_0_to_1()
            if p <= 0.8:
                c = chars[rng.rand_max(len(chars) - 1)]
                out.append(c.upper() if was_upper else c)
                i += 1
            elif p <= 0.9:
                c = chars[rng.rand_max(len(chars) - 1)]
                out.append(c.upper() if was_upper else c)
            else:
                i += 1
        else:
            out.append(seq[i])
            i += 1
    return "".join(out)


def mutate_fasta(text: str, rate: int, seed: int, width: int = 70) -> str:
    """`gt -seed S seqmutate -rate R -width W` over a FASTA text
    (ref: tools/gt_seqmutate.c)."""
    rng = YaRandom(seed)
    out = []
    desc, seqparts = None, []

    def flush():
        if desc is None:
            return
        seq = mutate_seq("".join(seqparts), rng, rate)
        out.append(f">{desc} [mutated with rate {rate}]")
        for i in range(0, len(seq), width):
            out.append(seq[i:i + width])

    for line in text.splitlines():
        if line.startswith(">"):
            flush()
            desc, seqparts = line[1:], []
        else:
            seqparts.append(line.strip())
    flush()
    return "\n".join(out) + "\n"
