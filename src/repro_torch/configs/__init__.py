"""Config registry of the port: the paper's Mamba-1 sizes."""
import importlib

_MODULES = ["mamba_110m", "mamba_1_4b", "mamba_2_8b"]


def load_all():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
