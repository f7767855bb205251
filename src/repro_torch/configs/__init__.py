"""Config registry of the port: the paper's Mamba-1 sizes, the Mamba-2
(SSD) evaluation size and the xLSTM and RecurrentGemma models of the JAX
package's assigned set."""
import importlib

_MODULES = ["mamba_110m", "mamba_1_4b", "mamba_2_8b", "mamba2_370m",
            "xlstm_125m", "recurrentgemma_2b"]


def load_all():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
