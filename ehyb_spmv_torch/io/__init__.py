from .mtx import read_mtx, write_mtx, read_header, MtxHeader, MtxError
from . import generate
