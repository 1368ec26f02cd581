"""End-to-end FedMM language-model pretraining (the counterpart of the
reference's ``examples/train_lm.py``): a thin wrapper over
``repro_torch.launch.train`` that trains a ~100M-parameter variant of an
architecture (``--preset 100m`` unless another preset is given) with the
FedMM trainer (quadratic surrogate, control variates, 8-bit uplink) on
heterogeneous synthetic token streams.

    python -m repro_torch.examples.train_lm --arch gemma3-12b \
        --steps 300 --batch 8 --seq 256
    PYTHONPATH=src python -m repro_torch.examples.train_lm --device cpu \
        --preset smoke --steps 20        # reduced, on the CPU

Any flag of ``repro_torch.launch.train`` is accepted. The default device
is the GPU; the CPU only when asked (``--device cpu``).
"""
import sys

from ..launch.train import main


def run(argv=None) -> dict:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not any(a.startswith("--preset") for a in argv):
        argv += ["--preset", "100m"]
    return main(argv)


if __name__ == "__main__":
    run()
