"""The plain reference of the benchmark: the model of the port at the
commit that wrote this benchmark, frozen (``models/``, ``config/``,
``utils/``, ``ops/``, ``parallel/``, ``data/``, ``device.py`` are copies of
the port's files), with every hand-written kernel replaced by plain
PyTorch: MSDA by the plain core differentiated by autograd
(``ops/msda.py``), the Hungarian matcher by its numpy solver on the host
(``ops/hungarian.py``), the greedy decode by teacher forcing. It imports
neither the port nor the JAX package. ``run.py`` drives it."""
