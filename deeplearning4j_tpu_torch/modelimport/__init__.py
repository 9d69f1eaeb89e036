"""Model import: counterpart of ``deeplearning4j_tpu/modelimport/``. The
TensorFlow frozen-graph importer is ported (``modelimport.tensorflow``);
the ONNX and Keras importers are still to be ported (ROADMAP A10.2)."""
