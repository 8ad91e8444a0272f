"""Host-side asset IO: TGA codec and OBJ mesh loading.

Arrays produced here are numpy; the scene compiler moves them to the
device. A native C++ fast path (`io/native.py`, over
`native/libpotato_native.so`) is used when the shared library loads; the
numpy paths stay the behavioural oracle.
"""
