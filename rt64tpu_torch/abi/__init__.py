"""The C ABI of the port: the public header (rt64_tpu.h), the embedding
shim (rt64_abi.cpp, librt64tpu_torch.so), the Python bridge it forwards
to (bridge.py), two headless sample hosts and their build (build.py)."""
