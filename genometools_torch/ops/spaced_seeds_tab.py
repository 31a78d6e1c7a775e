"""Tuned spaced-seed mask tables.

The port's copy of ``genometools_tpu/ops/spaced_seeds_tab.py``
(JAX-free host code; the port imports nothing of the reference
package).

Constant data imported from the reference (ref:
src/match/dbs_spaced_seeds.c gt_spaced_seed_spec_tab — tuned
per-(span, weight) seed bitmasks for spans 15..32; labeled constant
tables, like the codon tables in core/trans_table.py). Bit i of a mask
= care position (span - 1 - i) of the seed window.
"""

FIRST_SPAN = 15

SPAN_START = [0, 8, 16, 25, 34, 44, 54, 65, 76, 88, 100, 113, 126, 140, 154, 165, 176, 188]

FIRST_WEIGHT = [7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 17, 18, 18, 22]

SEED_TAB = [23075, 29331, 27975, 27823, 30135, 30575, 32495, 32511, 39559, 54039, 55511, 59767, 56687, 63215, 64479, 65471, 100891, 108075, 111271, 119415, 125751, 122287, 128879, 128959, 130943, 217383, 234071, 238903, 240951, 251503, 256887, 259823, 261087, 262015, 412715, 469271, 469399, 469615, 486575, 504751, 513775, 507359, 520127, 523263, 860951, 893607, 995927, 963375, 1009327, 1029039, 1027551, 1031647, 1040255, 1048319, 1902795, 1739175, 1880663, 1992015, 1952559, 1955487, 2055031, 2060015, 2080223, 2080511, 2095103, 3754263, 3969703, 3970407, 3847375, 3905119, 3909487, 4110063, 4126447, 4176863, 4177791, 4193791, 7508247, 7490215, 7950951, 7956055, 7951983, 8074607, 8219887, 8220399, 8240607, 8320991, 8355583, 8387583, 14848567, 15280743, 15911479, 15912111, 16149199, 16174767, 16469743, 16217535, 16629215, 16644031, 16760703, 16776191, 28387495, 31755435, 30624311, 31019727, 30775663, 32872879, 32303839, 32988063, 33222127, 32996319, 33283967, 33488639, 33546239, 61019287, 62007631, 62178639, 64578391, 64330095, 65755551, 65756383, 65894255, 66022335, 66026431, 66576127, 66977279, 67092479, 126495003, 122309719, 124131927, 124308175, 124954271, 129160607, 128896367, 131786479, 131784159, 131984863, 133151711, 133685183, 133954559, 134201343, 244880463, 254945615, 256519375, 255145071, 249914783, 262878623, 263615855, 263579375, 263634399, 264092639, 266303423, 267378559, 267909119, 268402687, 508768943, 513435311, 499881567, 525769951, 527260911, 527674815, 527920095, 532134879, 534640575, 534740735, 536345599, 1051087767, 1028869743, 1047213423, 1035629407, 1054521823, 1055717055, 1055878079, 1056373695, 1065220031, 1069514239, 1073479167, 2040932015, 2057774495, 2067064495, 2103078127, 2071258815, 2104348351, 2111548911, 2126216159, 2130115519, 2138828735, 2143223551, 2147220991, 4207733599, 4208813935, 4218133983, 4225429215, 4223523807, 4226775999, 4260872063, 4286545663, 4292868095]


def seed_span(mask: int) -> int:
    return mask.bit_length()


def seed_weight(mask: int) -> int:
    return bin(mask).count("1")


def weight_range(span: int) -> tuple[int, int]:
    """(min_weight, max_weight) available for a span (ref:
    gt_spaced_seed_weight_range, dbs_spaced_seeds.c:257)."""
    si = span - FIRST_SPAN
    if not 0 <= si < len(SPAN_START):
        raise ValueError(f"span {span} outside [{FIRST_SPAN}, "
                         f"{FIRST_SPAN + len(SPAN_START) - 1}]")
    end = SPAN_START[si + 1] if si + 1 < len(SPAN_START) else len(SEED_TAB)
    lo = FIRST_WEIGHT[si]
    return lo, lo + end - SPAN_START[si] - 1


def seed_for(weight: int, span: int) -> int:
    """The tuned mask for (weight, span) (ref:
    gt_spaced_seed_spec_new_from_ws, dbs_spaced_seeds.c:372)."""
    lo, hi = weight_range(span)
    if not lo <= weight <= hi:
        raise ValueError(f"weight {weight} outside [{lo}, {hi}] "
                         f"for span {span}")
    return SEED_TAB[SPAN_START[span - FIRST_SPAN] + weight - lo]
