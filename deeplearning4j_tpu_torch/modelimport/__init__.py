"""Model import: counterpart of ``deeplearning4j_tpu/modelimport/``. The
TensorFlow frozen-graph importer (``modelimport.tensorflow``) and the
ONNX importer (``modelimport.onnx``) are ported; the Keras importer is
still to be ported (ROADMAP A10.2)."""
