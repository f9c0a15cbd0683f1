"""Canonical forms of ``(target, mask, metric)`` queries.

PyTorch-port copy of the JAX package's ``core/canon.py`` (pure numpy; the
port imports nothing of that package).  Keys are digests over the same
canonical bytes, so a store written by either package answers the other.

The result store (``sboxgates_tpu_torch.store``) keys finished circuits on the
CANONICAL representative of a query's equivalence class under the group
the truth-table algebra makes cheap to act with:

* **input permutation** — relabeling the S-box input variables,
* **input negation** — complementing any subset of input variables,
* **output complement** — complementing the whole table.

Two tenants asking for ``f(x0, x1, x2)`` and ``~f(~x1, x0, x2)`` are
asking for the same circuit up to a zero-cost rewiring, so both queries
must map to ONE store key — and the store must be able to rewrite the
stored circuit back into each tenant's frame (``store.rewrite``).

A group element is a :class:`Transform` ``t = (perm, neg, comp)`` acting
on tables as ``(t . T)(y) = comp ^ T(x)`` where input variable
``perm[k]`` of the original frame carries ``y_k ^ neg[k]``.  The algebra
(:func:`apply_transform` / :func:`compose` / :func:`invert`) is closed
and property-tested; :func:`canonical_key` returns both the key and the
concrete transform from the QUERY frame to the canonical frame, so a hit
can compose "query -> canonical -> publisher" into one rewrite.

Canonicalization strategy (exact, not heuristic): the canonical table is
the lexicographic minimum of ``t . T`` over a candidate set restricted
by *covariant* invariants — conditions on the RESULT table only (its
popcount, its per-variable cofactor counts), so every member of an
equivalence class restricts to the same residual set and therefore the
same minimum.  For random-looking tables (real S-box outputs) the
invariants collapse the 2 * 2^n * n! group to a handful of candidates
and the column-elimination scan finishes in well under a millisecond;
highly symmetric tables (XOR-like) would blow the candidate set up, so
past :data:`CANON_CAP` candidates the query falls back to an
exact-digest key (``kind="x"``) — still content-addressed and correct,
it just stops merging frames for that pathological orbit.  The fallback
decision is itself orbit-invariant (the candidate count is), so
equivalent queries always agree on which keying they use.

Only the standard low-``2^n`` masks (:func:`ttable.mask_table`) get the
canonical treatment — the permutation group is then exactly the first
``n`` variables and the mask is invariant.  Any other mask shape keys
exactly (don't-care bits are zeroed first either way, so the key never
depends on values outside the mask).
"""

from __future__ import annotations

import hashlib
import itertools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from . import ttable as tt

#: Candidate-set ceiling for the exact lex-min scan.  Above this the
#: query keys exactly (see the module docstring); the bound keeps the
#: worst-case canonicalization cost (fully symmetric 8-input tables)
#: from turning store.get into a denial of service.
CANON_CAP = 4096

#: Key-format version — bump when the canonical form changes (old store
#: entries then simply stop matching instead of mismatching silently).
KEY_VERSION = 1


@dataclass(frozen=True)
class Transform:
    """One group element; ``perm[k]`` is the ORIGINAL variable index
    feeding transformed variable ``k`` (negated when ``neg[k]``), and
    ``comp`` complements the output."""

    perm: Tuple[int, ...]
    neg: Tuple[int, ...]
    comp: int

    @property
    def n(self) -> int:
        return len(self.perm)

    def is_identity(self) -> bool:
        return (
            self.comp == 0
            and not any(self.neg)
            and all(p == k for k, p in enumerate(self.perm))
        )


def identity_transform(n: int) -> Transform:
    return Transform(tuple(range(n)), (0,) * n, 0)


def _index_map(perm, neg) -> np.ndarray:
    """``x`` such that ``(t . T)[j] = comp ^ T[x[j]]`` for j < 2^n."""
    n = len(perm)
    j = np.arange(1 << n)
    x = np.zeros(1 << n, dtype=np.int64)
    for k in range(n):
        x |= (((j >> k) & 1) ^ int(neg[k])) << int(perm[k])
    return x


def apply_transform(t: Transform, table) -> np.ndarray:
    """``t . T`` as uint32 words; positions >= 2^n are zeroed (outside
    the canonical domain)."""
    bits = tt.to_bits(np.asarray(table, dtype=np.uint32))
    out = np.zeros(tt.TABLE_BITS, dtype=bool)
    dom = 1 << t.n
    out[:dom] = bits[_index_map(t.perm, t.neg)] ^ bool(t.comp)
    return tt.from_bits(out)


def compose(t2: Transform, t1: Transform) -> Transform:
    """``t2 o t1`` (apply ``t1`` first): ``(t2 o t1) . T = t2 . (t1 . T)``."""
    assert t1.n == t2.n
    n = t1.n
    perm = tuple(t1.perm[t2.perm[k]] for k in range(n))
    neg = tuple(t2.neg[k] ^ t1.neg[t2.perm[k]] for k in range(n))
    return Transform(perm, neg, t1.comp ^ t2.comp)


def invert(t: Transform) -> Transform:
    """``t^-1`` such that ``compose(invert(t), t)`` is the identity."""
    n = t.n
    inv = [0] * n
    for k, p in enumerate(t.perm):
        inv[p] = k
    perm = tuple(inv)
    neg = tuple(t.neg[perm[i]] for i in range(n))
    return Transform(perm, neg, t.comp)


def standard_mask_inputs(mask) -> Optional[int]:
    """``n`` when ``mask`` is exactly :func:`ttable.mask_table`'s
    low-``2^n`` form (the only mask the search drivers produce), else
    None — non-standard care-sets key exactly."""
    mask = np.asarray(mask, dtype=np.uint32)
    for n in range(1, 9):
        if np.array_equal(mask, tt.mask_table(n)):
            return n
    return None


def _digest(*parts: bytes) -> str:
    h = hashlib.blake2b(digest_size=20)
    for p in parts:
        h.update(p)
    return h.hexdigest()


def exact_key(target, mask, metric: int) -> str:
    """Exact-digest key (identity frame only): used for non-standard
    masks and over-:data:`CANON_CAP` symmetric orbits.  Don't-care bits
    are zeroed first, so the key never depends on values the mask
    excludes."""
    target = np.asarray(target, dtype=np.uint32)
    mask = np.asarray(mask, dtype=np.uint32)
    masked = (target & mask).astype("<u4")
    return "x%d-%s" % (
        int(metric),
        _digest(bytes([KEY_VERSION]), masked.tobytes(),
                mask.astype("<u4").tobytes()),
    )


def exact_multi_key(targets, mask, metric: int) -> str:
    """Exact key for a MULTI-output query (the all-outputs beam search):
    one digest over the per-bit tables in output order.  Multi-output
    joint canonicalization (shared input transform, per-bit complements,
    output reordering) is not attempted — cross-tenant repeats of whole
    S-boxes are overwhelmingly exact repeats."""
    mask = np.asarray(mask, dtype=np.uint32)
    parts = [bytes([KEY_VERSION, len(targets)]),
             mask.astype("<u4").tobytes()]
    for targ in targets:
        masked = (np.asarray(targ, dtype=np.uint32) & mask).astype("<u4")
        parts.append(masked.tobytes())
    return "m%d-%s" % (int(metric), _digest(*parts))


def _candidate_transforms(bits: np.ndarray, n: int):
    """The covariantly-restricted candidate set for ``bits`` (bool,
    length 2^n): arrays ``(P, NU, C)`` of per-candidate permutations,
    negations, and output complements, or None past :data:`CANON_CAP`.

    Restrictions (all conditions on the RESULT table, hence shared by
    every member of the orbit):

    * complement: the result's popcount is <= 2^(n-1) (tie: both),
    * negation: each result variable's 0-cofactor count <= its
      1-cofactor count (tie: both polarities),
    * permutation: the result's per-variable (min, max) cofactor-count
      pairs are non-decreasing (ties: all orders within a tie group).
    """
    dom = 1 << n
    idx = np.arange(dom)
    w = int(bits.sum())
    if 2 * w < dom:
        comp_choices = (0,)
    elif 2 * w > dom:
        comp_choices = (1,)
    else:
        comp_choices = (0, 1)

    rows: List[Tuple[int, Tuple[int, ...], Tuple[int, ...]]] = []
    total = 0
    for c in comp_choices:
        cb = bits ^ bool(c)
        wc = int(cb.sum())
        c1 = np.array(
            [int(cb[((idx >> i) & 1) == 1].sum()) for i in range(n)]
        )
        c0 = wc - c1
        negs = [
            (0,) if c0[i] < c1[i] else (1,) if c0[i] > c1[i] else (0, 1)
            for i in range(n)
        ]
        sig = [(int(min(c0[i], c1[i])), int(max(c0[i], c1[i])))
               for i in range(n)]
        order = sorted(range(n), key=lambda i: sig[i])
        groups: List[List[int]] = []
        for i in order:
            if groups and sig[groups[-1][0]] == sig[i]:
                groups[-1].append(i)
            else:
                groups.append([i])
        count = 1
        for g in groups:
            for f in range(2, len(g) + 1):
                count *= f
        for i in range(n):
            count *= len(negs[i])
        total += count
        if total > CANON_CAP:
            return None
        for parts in itertools.product(
            *[itertools.permutations(g) for g in groups]
        ):
            perm = tuple(v for part in parts for v in part)
            for nu in itertools.product(*[negs[v] for v in perm]):
                rows.append((c, perm, nu))
    P = np.array([p for _, p, _ in rows], dtype=np.int64)
    NU = np.array([nu for _, _, nu in rows], dtype=np.int64)
    C = np.array([c for c, _, _ in rows], dtype=np.uint8)
    return P, NU, C


def canonicalize(target, mask, metric: int):
    """``(key, transform)`` for one single-output query.

    ``transform`` maps the QUERY frame to the canonical frame
    (``apply_transform(transform, target & mask)`` IS the canonical
    table) and is None exactly when the key is exact-kind (non-standard
    mask, or a past-cap symmetric orbit) — those entries only ever match
    identity-frame repeats.  Deterministic: the same query always yields
    the same transform, so a repeated query composes to an identity
    rewrite and gets the stored bytes back untouched."""
    target = np.asarray(target, dtype=np.uint32)
    mask = np.asarray(mask, dtype=np.uint32)
    n = standard_mask_inputs(mask)
    if n is None:
        return exact_key(target, mask, metric), None
    dom = 1 << n
    bits = tt.to_bits(target & mask)[:dom]
    cands = _candidate_transforms(bits, n)
    if cands is None:
        return exact_key(target, mask, metric), None
    P, NU, C = cands
    Tb = bits.astype(np.uint8)
    kbits = np.arange(n)
    canon = np.zeros(dom, dtype=np.uint8)
    for j in range(dom):
        if len(P) == 1:
            canon = C[0] ^ Tb[_index_map(P[0], NU[0])]
            break
        jb = (j >> kbits) & 1
        x = ((jb[None, :] ^ NU) << P).sum(axis=1)
        b = C ^ Tb[x]
        mn = b.min()
        canon[j] = mn
        if b.max() != mn:
            keep = b == mn
            P, NU, C = P[keep], NU[keep], C[keep]
    key = "c%d-%d-%s" % (
        n, int(metric),
        _digest(bytes([KEY_VERSION, n]), canon.tobytes()),
    )
    return key, Transform(tuple(int(v) for v in P[0]),
                          tuple(int(v) for v in NU[0]), int(C[0]))
