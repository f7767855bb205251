"""The roofline of the port on its card (port of ``repro.roofline``): the
card's peaks and the three-term ``Roofline`` (``analysis.py``), the
kernels' bytes, operations and bounds (``kernel_model.py``), one count of a
step's work that reads the same on the meta device, the CPU and the card
(``counter.py``), and the dry-run tables (``report.py``)."""
