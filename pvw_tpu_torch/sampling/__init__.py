"""Sampling: the CBD, bounded-uniform and truncated-Gaussian samplers
(the reference's ``src/sampling/mod.rs``)."""
from .cbd import cbd_bound, sample_vec_cbd, sample_vec_cbd_rows
from .uniform import (sample_bounded_u64, sample_uniform_coefficients, sample_uniform_residues,
                      sample_uniform_residues_host, sample_uniform_residues_rows,
                      sample_uniform_signed_rows)
from .normal import (
    TAIL_STDDEV_MULTIPLIER,
    box_muller,
    sample_bigint_normal_bits,
    sample_bigint_normal_u64,
    sample_bigint_normal_vec,
    sample_bigint_normal_vec_bits,
    sample_bigint_normal_vec_u64,
    sample_discrete_gaussian_vec,
)

__all__ = ["TAIL_STDDEV_MULTIPLIER", "box_muller", "cbd_bound", "sample_bigint_normal_bits",
           "sample_bigint_normal_u64", "sample_bigint_normal_vec",
           "sample_bigint_normal_vec_bits", "sample_bigint_normal_vec_u64",
           "sample_bounded_u64", "sample_discrete_gaussian_vec", "sample_uniform_coefficients",
           "sample_uniform_residues", "sample_uniform_residues_host",
           "sample_uniform_residues_rows", "sample_uniform_signed_rows", "sample_vec_cbd",
           "sample_vec_cbd_rows"]
