"""Sketch-space configuration and derived bit geometry.

The reference encodes this state in a mix of a ``.shuf`` file header
(``dim_shuffle_stat_t``: command_shuffle.h:17-23), compile-time macros
(``COMPONENT_SZ``, ``CTX_SPC_USE_L``: global_basic.h:42-47) and globals
initialised by ``seq2co_global_var_initial`` (iseq2comem.c:54-77).
Here everything is one frozen dataclass; the compile-time macros become
runtime fields.

Glossary (a "k-mer" is ``2k`` bases, CLI ``-k`` is the half length):

  half_ctx_len (k)      half k-mer length;  k-mer = 4k bits
  half_subctx_len (s)   half length of the inner substring; inner = 4s bits
  drlevel (l)           dimensionality-reduction level, sampling rate 16^-l
  layout of the 4k-bit canonical k-mer word::

      [ left outer 2(k-s) bits | inner 4s bits | right outer 2(k-s) bits ]

  drtuple               kept k-mer repacked to 4(k-l) bits =
                        (outer_left || outer_right) >> 4l  +  rank(inner)
"""

from __future__ import annotations

import dataclasses

MIN_SUBCTX_DIM_SMP_SZ = 4096  # command_shuffle.h:29
LD_FCTR = 0.6  # global_basic.h:49
DEFAULT_COMPONENT_SZ = 7  # Makefile:4 (-DCOMPONENT_SZ=7)
DEFAULT_CTX_SPC_USE_L = 8  # global_basic.h:45-47

# Primes just below powers of two, primer[i] < 2^(i+8)  (global_basic.c:74-81)
PRIMER = (
    251, 509, 1021, 2039, 4093, 8191, 16381,
    32749, 65521, 131071, 262139, 524287,
    1048573, 2097143, 4194301, 8388593, 16777213,
    33554393, 67108859, 134217689, 268435399,
    536870909, 1073741789, 2147483647, 4294967291,
)


def add_len_drlevel2subk() -> int:
    """Default ``subk - drlevel`` gap: ceil(log2(4096)/4) = 3.

    Mirrors command_shuffle.c:154-160.
    """
    min_smp_len = MIN_SUBCTX_DIM_SMP_SZ.bit_length() - 1  # 12
    return -(-min_smp_len // 4)


@dataclasses.dataclass(frozen=True)
class SketchParams:
    """Full sketch-space geometry; see module docstring.

    ``id`` is the random fingerprint of the shuffled-space permutation;
    it is checked whenever sketches/databases are combined
    (command_dist.c:129-133, 446-451).
    """

    id: int
    half_ctx_len: int  # k
    half_subctx_len: int  # s (subk)
    drlevel: int  # l
    component_sz: int = DEFAULT_COMPONENT_SZ
    ctx_spc_use_l: int = DEFAULT_CTX_SPC_USE_L

    # ---- aliases matching the reference names ----
    @property
    def k(self) -> int:
        return self.half_ctx_len

    @property
    def subk(self) -> int:
        return self.half_subctx_len

    @property
    def kmerlen(self) -> int:
        """Full k-mer length in bases (command_dist.c:364)."""
        return 2 * self.half_ctx_len

    @property
    def dim_rd_len(self) -> int:
        """Dimension-reduction length field of stat files (command_dist.c:365)."""
        return 2 * self.drlevel

    # ---- bit geometry (iseq2comem.c:54-77) ----
    @property
    def half_outctx_len(self) -> int:
        return self.half_ctx_len - self.half_subctx_len

    @property
    def TL(self) -> int:
        """Window length in bases (= kmerlen)."""
        return 2 * self.half_ctx_len

    @property
    def tupmask(self) -> int:
        """Mask keeping the low 4k bits (iseq2comem.c:67)."""
        return (1 << (4 * self.half_ctx_len)) - 1

    @property
    def crvsaddmove(self) -> int:
        """Shift planting a new base at the top of the revcomp register."""
        return 4 * self.half_ctx_len - 2

    @property
    def domask(self) -> int:
        """Extracts the inner 4s-bit substring (iseq2comem.c:69)."""
        return ((1 << (4 * self.half_subctx_len)) - 1) << (2 * self.half_outctx_len)

    @property
    def undomask(self) -> int:
        """Extracts the left outer half (iseq2comem.c:70-71)."""
        return ((1 << (2 * self.half_outctx_len)) - 1) << (
            2 * (self.half_ctx_len + self.half_subctx_len)
        )

    @property
    def rightmask(self) -> int:
        """Extracts the right outer half (inline in iseq2comem.c:250-251)."""
        return (1 << (2 * self.half_outctx_len)) - 1

    @property
    def dim_shuf_len(self) -> int:
        """Size of the shuffled inner-substring space, 16^s."""
        return 1 << (4 * self.half_subctx_len)

    @property
    def dim_start(self) -> int:
        return 0

    @property
    def dim_end(self) -> int:
        """Keep threshold: max(16^(s-l), 4096)  (iseq2comem.c:75-76)."""
        subspace_sz = 1 << (4 * (self.half_subctx_len - self.drlevel))
        return self.dim_start + max(subspace_sz, MIN_SUBCTX_DIM_SMP_SZ)

    @property
    def drtuple_bits(self) -> int:
        """Bits of a sketch code before component split: 4(k-l)."""
        return 4 * (self.half_ctx_len - self.drlevel)

    # ---- component split (iseq2comem.c:63-64, 80) ----
    @property
    def component_num(self) -> int:
        excess = self.half_ctx_len - self.drlevel - self.component_sz
        return 1 << (4 * excess) if excess > 0 else 1

    @property
    def comp_code_bits(self) -> int:
        excess = self.half_ctx_len - self.drlevel - self.component_sz
        return 4 * excess if excess > 0 else 0

    @property
    def comp_sz(self) -> int:
        """Per-component code-row space, 16^COMPONENT_SZ (co2mco.c:29)."""
        return 1 << (4 * self.component_sz)

    # ---- dedup hash table sizing (command_dist.c:217-236) ----
    @property
    def hashsize(self) -> int:
        primer_ind = 4 * (self.half_ctx_len - self.drlevel) - self.ctx_spc_use_l - 7
        if primer_ind < 0 or primer_ind > 24:
            raise ValueError(
                f"hash primer index {primer_ind} out of range 0..24; "
                f"k={self.half_ctx_len} drlevel={self.drlevel} unsupported"
            )
        return PRIMER[primer_ind]

    @property
    def hashlimit(self) -> int:
        """Distinct-key limit before 'space too crowded' (iseq2comem.c:61)."""
        return int(self.hashsize * LD_FCTR)

    def __post_init__(self):
        if self.half_ctx_len < self.half_subctx_len:
            raise ValueError("half_ctx_len (k) must be >= half_subctx_len (s)")
        if self.half_subctx_len >= 8:
            raise ValueError("half_subctx_len (s) must be < 8")
        if self.drlevel < 0 or self.drlevel > self.half_subctx_len:
            raise ValueError("drlevel (l) must be within [0, s]")
        if 4 * self.half_ctx_len > 64:
            raise ValueError("k-mer does not fit 64 bits: need k <= 16")

    @classmethod
    def create(
        cls,
        k: int,
        drlevel: int,
        subk: int | None = None,
        id: int | None = None,
        component_sz: int = DEFAULT_COMPONENT_SZ,
        seed: int | None = None,
    ) -> "SketchParams":
        """Build params the way ``kssd dist -k .. -L <level>`` does
        (command_dist.c:200-207): subk defaults to drlevel + 3."""
        if subk is None:
            subk = drlevel + add_len_drlevel2subk()
        if id is None:
            import random

            id = random.Random(seed).randrange(0, 2**31)
        return cls(
            id=id,
            half_ctx_len=k,
            half_subctx_len=subk,
            drlevel=drlevel,
            component_sz=component_sz,
        )


def _is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (fixed witness set)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d, r = n - 1, 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def largest_prime_below_pow2(w: int) -> int:
    """Largest prime < 2^w (find_lgst_primer_2pow, global_basic.c:364-388;
    used by the hidden ``primer`` subcommand, global_wrapper.c:107-109)."""
    n = (1 << w) - 1
    while not _is_prime(n):
        n -= 2 if n % 2 else 1
    return n
