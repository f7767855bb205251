"""Config registry of the port: the paper's Mamba-1 sizes, the Mamba-2
(SSD) evaluation size and the xLSTM, RecurrentGemma and dense models of
the JAX package's assigned set."""
import importlib

_MODULES = ["mamba_110m", "mamba_1_4b", "mamba_2_8b", "mamba2_370m",
            "xlstm_125m", "recurrentgemma_2b", "stablelm_1_6b", "gemma_7b",
            "deepseek_coder_33b", "deepseek_67b"]


def load_all():
    for m in _MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")
