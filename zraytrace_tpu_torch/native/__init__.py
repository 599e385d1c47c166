"""Host-side preprocessing in C++ (the OBJ parser and the binned-SAH BVH
builder), reached through ctypes (``native/api.py``)."""
