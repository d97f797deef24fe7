"""Runtime pieces of the port that are not kernels: the bridge to the
repo's native C++ attention oracle (`native`)."""
