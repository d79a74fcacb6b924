"""Export: the ``.mww`` deployment artifact for the C++ streaming runtime,
float (``native_runtime``) and full-int8 (``native_quant``)."""

from microwakeword_tpu_torch.export.native_runtime import export_model  # noqa: F401
