"""The study and soak programs of the port, one module per program of the
JAX package's ``scripts/`` and with its name:

    python -m hybrid9_tpu_torch.scripts.<name> [arguments]

Each module has ``main(argv=None) -> int`` with the JAX program's
arguments, defaults and exit codes, and runs on the card unless
``--device`` names another (``--device cpu``).  ``--no-pallas`` is
``--no-kernel`` here (the plain PyTorch twin of the day kernel).  The
outputs a JAX program writes at the repository's root or beside itself
carry ``_torch`` in their default names, so that running the port never
overwrites the JAX package's records (``zd09_drift_torch.json``,
``nisurf_study_torch.csv``, ``vaira_chain_torch.csv``).
"""
