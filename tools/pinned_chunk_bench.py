"""Page-locking the host tier's chunks: PyTorch's caching host allocator
(``pin_memory=True``, blocks rounded up to a power of two) against
``cudaHostRegister`` of a plain tensor before and after it is filled, 7
chunks of 270 MiB each, twice (the second round finds the caching
allocator's freed blocks). Needs a card.

    python3 tools/pinned_chunk_bench.py
"""
import time
import torch

N = 7
NBYTES = 270 << 20
src = torch.empty(NBYTES, dtype=torch.uint8)
src.fill_(3)
cudart = torch.cuda.cudart()
print("threads", torch.get_num_threads(), flush=True)


def timed(name, fn):
    keep = []
    t0 = time.perf_counter()
    for _ in range(N):
        keep.append(fn())
    dt = time.perf_counter() - t0
    print(f"{name}: {dt * 1e3:.1f} ms for {N} x {NBYTES >> 20} MiB "
          f"({N * NBYTES / dt / 1e9:.2f} GB/s)", flush=True)
    for k in keep:
        if isinstance(k, tuple):
            cudart.cudaHostUnregister(k[1])
    return keep


def caching():
    b = torch.empty(NBYTES, dtype=torch.uint8, pin_memory=True)
    b.copy_(src)
    return b


def register_then_fill():
    b = torch.empty(NBYTES, dtype=torch.uint8)
    assert int(cudart.cudaHostRegister(b.data_ptr(), NBYTES, 0)) == 0
    b.copy_(src)
    return (b, b.data_ptr())


def fill_then_register():
    b = torch.empty(NBYTES, dtype=torch.uint8)
    b.copy_(src)
    assert int(cudart.cudaHostRegister(b.data_ptr(), NBYTES, 0)) == 0
    return (b, b.data_ptr())


for rep in range(2):
    timed("caching host allocator (pin_memory=True) + fill", caching)
    timed("register, then fill", register_then_fill)
    timed("fill, then register", fill_then_register)
    print(torch.cuda.host_memory_stats().get("allocated_bytes.current"), flush=True)
