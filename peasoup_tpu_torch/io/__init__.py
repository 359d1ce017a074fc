from .sigproc import (
    SigprocHeader,
    read_sigproc_header,
    write_sigproc_header,
    Filterbank,
    read_filterbank,
    write_filterbank,
    unpack_bits,
    pack_bits,
)
from .masks import read_killfile, read_zapfile
