from .coo import MatrixCOO, deterministic_x, oracle_spmv
