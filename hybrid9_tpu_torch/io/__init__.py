"""Host I/O: NetCDF files, the native host library, annual output and
checkpoints."""
