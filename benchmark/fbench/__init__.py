"""The benchmark harness of ``gpufluidsimulator_torch`` (see ../README.md).

Nothing in this package imports JAX or ``gpufluidsimulator_tpu``.  Only
``program.py`` imports the system under test; ``reference.py`` imports
torch and numpy alone.
"""
