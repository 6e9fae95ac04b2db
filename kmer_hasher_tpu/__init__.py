"""kmer_hasher_tpu — an accelerator k-mer indexing and counting engine.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
lmjakt/kmer_hasheR (an R/C extension built on khash): 2-bit packed k-mer
position indexes and dot-plot coordinate extraction, cross-sequence queries,
quality-aware canonical k-mer counting over FASTA/FASTQ, k-mer spectra and
per-position depth tracks — replacing pointer-chasing hash tables with
sort-based segmented grouping over dense arrays, sharded across device
meshes by k-mer key.

Public API lives in :mod:`kmer_hasher_tpu.api` and mirrors the reference's R
surface (kmer_hash.R:5-96) with typed configs instead of positional int
vectors.
"""

__version__ = "0.1.0"

import jax as _jax

# 64-bit mode: pair-table offsets exceed 2^31 (the reference documents >9e9
# pairs from a 40 Mbp 32-mer index, README.md:80-89) and the quality
# -likelihood filter must accumulate in float64 to reproduce the C double
# arithmetic bit-for-bit. All hot-path arrays pin explicit 32-bit dtypes, so
# this only widens where intended.
_jax.config.update("jax_enable_x64", True)

# Persistent XLA compilation cache: the sort and scan programs take long
# to compile. JAX reads JAX_COMPILATION_CACHE_DIR itself; without it the
# cache sits at a fixed path inside the checkout (the path is part of the
# cache key, so it must not move between runs).
import os as _os

if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    _jax.config.update(
        "jax_compilation_cache_dir",
        _os.path.join(_os.path.dirname(_os.path.dirname(
            _os.path.abspath(__file__))), ".jax_cache"),
    )
    _jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)

from . import refsem  # noqa: F401,E402  (parity oracle, import-light)

__all__ = ["refsem", "__version__"]
