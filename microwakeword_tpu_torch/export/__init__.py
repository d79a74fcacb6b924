"""Export: the deployment artifacts of a trained model.

- ``native_runtime`` / ``native_quant``: ``.mww`` for the C++ streaming
  runtime, float and full int8;
- ``torch_export``: ``.mwwt``, the serialized ``torch.export`` programs;
- ``tflite`` and ``manifest``: the streaming ``.tflite`` (float or int8) and
  its ESPHome manifest (needs TensorFlow on the host).
"""

from microwakeword_tpu_torch.export.native_runtime import export_model  # noqa: F401
