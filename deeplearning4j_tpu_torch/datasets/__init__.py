"""Datasets and iterators: counterpart of ``deeplearning4j_tpu/datasets``
(``DataSet``, ``MultiDataSet``, the iterators, normalizers, the local-file
fetchers, the host and device prefetchers and the class-imbalance
preprocessors). The record-reader iterators are stand-ins that raise."""

from deeplearning4j_tpu_torch.datasets.dataset import DataSet
from deeplearning4j_tpu_torch.datasets.iterator import (
    ArrayDataSetIterator, DataSetIterator, ListDataSetIterator)
from deeplearning4j_tpu_torch.datasets.record_reader_iterator import (
    AsyncDataSetIterator, RecordReaderDataSetIterator,
    RecordReaderMultiDataSetIterator, SequenceRecordReaderDataSetIterator)
from deeplearning4j_tpu_torch.datasets.fetchers import (
    Cifar10DataSetIterator, EmnistDataSetIterator, IrisDataSetIterator,
    MnistDataSetIterator)
from deeplearning4j_tpu_torch.datasets.multi_dataset import (
    ArrayMultiDataSetIterator, ListMultiDataSetIterator, MultiDataSet,
    MultiDataSetIterator, MultiDataSetIteratorAdapter)
from deeplearning4j_tpu_torch.datasets.iterator_utils import (
    CachingDataSetIterator, EarlyTerminationDataSetIterator,
    ExistingMiniBatchDataSetIterator, KFoldIterator, MultipleEpochsIterator,
    SamplingDataSetIterator, ViewIterator)
from deeplearning4j_tpu_torch.datasets.device_prefetch import (
    BatchShapePolicy, DevicePrefetchIterator, DevicePrefetchMultiIterator)

__all__ = ["DataSet", "DataSetIterator", "ListDataSetIterator",
           "ArrayDataSetIterator", "AsyncDataSetIterator",
           "RecordReaderDataSetIterator",
           "RecordReaderMultiDataSetIterator",
           "SequenceRecordReaderDataSetIterator",
           "IrisDataSetIterator", "MnistDataSetIterator",
           "EmnistDataSetIterator", "Cifar10DataSetIterator",
           "MultiDataSet", "MultiDataSetIterator",
           "ListMultiDataSetIterator", "ArrayMultiDataSetIterator",
           "MultiDataSetIteratorAdapter",
           "KFoldIterator", "ViewIterator", "SamplingDataSetIterator",
           "MultipleEpochsIterator", "EarlyTerminationDataSetIterator",
           "CachingDataSetIterator", "ExistingMiniBatchDataSetIterator",
           "BatchShapePolicy", "DevicePrefetchIterator",
           "DevicePrefetchMultiIterator"]
