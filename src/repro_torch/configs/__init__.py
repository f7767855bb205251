"""Config registry of the port: the paper's Mamba-1 sizes and the Mamba-2
(SSD) evaluation size."""
import importlib

_MODULES = ["mamba_110m", "mamba_1_4b", "mamba_2_8b", "mamba2_370m"]


def load_all():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
