"""Batched serving example (the counterpart of the reference's
``examples/serve_batched.py``): prefill + greedy decode with the
ring-buffer KV cache and optional int8 cache quantization, through
``repro_torch.launch.serve.main`` (weights random from a seed).

    python -m repro_torch.examples.serve_batched --arch gemma3-12b \
        --batch 4 --prompt-len 32 --new-tokens 16 --int8-kv
    python -m repro_torch.examples.serve_batched --arch gemma3-12b \
        --preset full --batch 4 --prompt-len 2048 --new-tokens 32
    PYTHONPATH=src python -m repro_torch.examples.serve_batched \
        --arch gemma3-12b --device cpu       # reduced, on the CPU

The default device is the GPU; the CPU only when asked (``--device cpu``).
"""
from ..launch.serve import main

if __name__ == "__main__":
    main()
