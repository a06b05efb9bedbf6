"""Models of the port: :mod:`.deepfm` (the DeepFM CTR model),
:mod:`.label_semantic_roles` (the CoNLL-05 SRL tagger with a CRF),
:mod:`.machine_translation` (the attention seq2seq, training and beam
search), :mod:`.mnist` (LeNet), :mod:`.ocr_crnn_ctc` (the CRNN-CTC text
recognizer), :mod:`.recommender` (the MovieLens two-tower model),
:mod:`.resnet` (ResNet-50 and the CIFAR-10 ResNets), :mod:`.se_resnext`
(SE-ResNeXt-50/101/152), :mod:`.ssd` (MobileNet-SSD),
:mod:`.stacked_dynamic_lstm` (IMDB sentiment), :mod:`.transformer`,
:mod:`.vgg` (VGG-16 with batch norm) and :mod:`.word2vec` (the n-gram
language model)."""
from . import deepfm  # noqa: F401
from . import label_semantic_roles  # noqa: F401
from . import machine_translation  # noqa: F401
from . import mnist  # noqa: F401
from . import ocr_crnn_ctc  # noqa: F401
from . import recommender  # noqa: F401
from . import resnet  # noqa: F401
from . import se_resnext  # noqa: F401
from . import ssd  # noqa: F401
from . import stacked_dynamic_lstm  # noqa: F401
from . import transformer  # noqa: F401
from . import vgg  # noqa: F401
from . import word2vec  # noqa: F401
