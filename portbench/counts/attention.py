"""The attention's operations, bytes and least time, from its shapes.

Pairs are the (query, key) pairs the mask keeps: S (S + 1) / 2 a head and
sequence when causal (half the square and the diagonal), S^2 otherwise.
The forward needs two products over them (q k^T, p v), the backward four
(p^T dO, dO v^T, dS k, dS^T q); a recomputed q k^T is not counted. Bytes
count each input read once and each output written once: q, o, dO, dQ at
the query heads, k, v, dK, dV at the key/value heads (GQA's 8, not the 32
a kernel may be handed), the fp32 log-sum-exp once a row and head."""


from portbench import peaks


def pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def fwd_flops(b, s, n, hd, causal) -> float:
    return 4.0 * b * n * hd * pairs(s, causal)


def bwd_flops(b, s, n, hd, causal) -> float:
    return 8.0 * b * n * hd * pairs(s, causal)


def fwd_bytes(b, s, n, n_kv, hd, itemsize=2) -> float:
    return (2 * b * s * n * hd + 2 * b * s * n_kv * hd) * itemsize \
        + 4 * b * n * s


def bwd_bytes(b, s, n, n_kv, hd, itemsize=2) -> float:
    return (4 * b * s * n * hd + 4 * b * s * n_kv * hd) * itemsize \
        + 4 * b * n * s


def least_s(which: str, b, s, n, n_kv, hd, causal) -> float:
    """The least time of one attention call on the card, forward
    (``which`` "fwd") or backward ("bwd"): the larger of its operations at
    the bf16 peak and its bytes at the memory rate."""
    if which == "fwd":
        return peaks.roofline_s(fwd_flops(b, s, n, hd, causal),
                                fwd_bytes(b, s, n, n_kv, hd))
    return peaks.roofline_s(bwd_flops(b, s, n, hd, causal),
                            bwd_bytes(b, s, n, n_kv, hd))
