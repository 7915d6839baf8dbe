"""File I/O: mesh loaders, .sdf files, the native host library."""
