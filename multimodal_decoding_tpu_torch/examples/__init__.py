"""The port's counterparts of ``examples/*.py``: the same arguments (``--tpu``
and ``--cpu`` become ``--device``, default ``cuda``), the same printed lines
and the same artifacts, through the port only.  Run each as

    python -m multimodal_decoding_tpu_torch.examples.<name> [--device cpu] ...

Each module's ``main(argv=None)`` takes the arguments as a list, so the
tests and chip_smoke.py call it in-process.
"""
