"""repro_torch — the SpKAdd engine ported to PyTorch and CUDA (Hopper).

A second package beside ``repro`` (the JAX/Pallas reference), mirroring its
module names: ``core.*`` (sparse, spkadd, engine, topk, streaming,
stream_service, allreduce, spgemm), ``kernels.*``, ``runtime.*``,
``checkpoint``, ``optim``, ``models`` (the dense decoder family),
``configs``, ``data``, ``train.step``, ``sharding``, ``launch.*`` (with
the dry-run and its cost analysis), ``obs`` (with the ledger),
``analysis`` (spkaddlint) and ``compat``, plus ``tree`` (parameter trees
in JAX's leaf order). It imports neither JAX
nor anything of ``repro``. Entry points follow their input tensors'
device: on a CUDA card every kernel-backed step launches a hand-written
CUDA kernel (``kernels/csrc``, built with ``nvcc`` at first use); on the
CPU the kernels' plain PyTorch versions run.
"""
