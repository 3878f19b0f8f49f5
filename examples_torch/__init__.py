"""The JAX package's examples (``examples/*.py``) on the PyTorch port.

Each module runs as a script (``PYTHONPATH=src python
examples_torch/quickstart.py --device cpu``) on the card unless
``--device cpu`` is given, prints the reference example's lines, and
has a ``main`` that returns a dict of everything it printed.
"""
