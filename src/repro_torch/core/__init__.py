"""The paper's reflection stack on the port: the reflect-and-revise
controller (``reflection.py``), the online sweet-spot router
(``controller.py``), feedback providers, budget tiers, Bedrock cost and
latency accounting, Pareto frontiers, the calibrated quality simulator
and significance tests.  Each module is a copy of ``repro/core``'s
counterpart (checked by ``tests/test_torch_core.py``) that serves over
the port's ``serving/engine.py::Engine``."""
