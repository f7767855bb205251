"""``python -m repro_torch.tune --check [path]`` — the cache's health check
(``cache._main``; an entry of its own keeps runpy from executing the
already-imported cache module again)."""
from repro_torch.tune.cache import _main

if __name__ == "__main__":
    _main()
