"""Operations of the port: host AES and PRG, and the CUDA kernels B1-B3
with their plain PyTorch versions."""
