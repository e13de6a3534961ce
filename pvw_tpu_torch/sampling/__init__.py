from .cbd import sample_vec_cbd, sample_vec_cbd_rows
from .uniform import (sample_bounded_u64, sample_uniform_residues_host,
                      sample_uniform_residues_rows, sample_uniform_signed_rows)

__all__ = ["sample_bounded_u64", "sample_uniform_residues_host",
           "sample_uniform_residues_rows", "sample_uniform_signed_rows", "sample_vec_cbd",
           "sample_vec_cbd_rows"]
