from .kernel import bsr_spmv
from .ops import BsrMatrix, bsr_from_edges
from .ref import (bsr_spmv_ref, dense_from_bsr, dense_semiring_mv,
                  plus_times_bounds)
from .rows import bsr_spmv_rows, bsr_spmv_rows_ref
from .semiring import (MIN_PLUS, OR_AND, PLUS_TIMES, SEMIRINGS, Semiring,
                       get_semiring)

__all__ = ["bsr_spmv", "bsr_spmv_rows", "bsr_spmv_rows_ref", "BsrMatrix", "bsr_from_edges",
           "bsr_spmv_ref", "dense_from_bsr", "dense_semiring_mv",
           "plus_times_bounds",
           "Semiring", "SEMIRINGS", "get_semiring",
           "PLUS_TIMES", "MIN_PLUS", "OR_AND"]
