"""The benchmark's general code: the manifest, the data made from the
seed, the program's serving path, the trace, the work counts and the
check that decides ``correct``.  What belongs to one configuration,
traffic mix or metric lives in files of its own (``configs/``,
``traffic/``, ``metrics/``, ``reference/``), found by name."""
