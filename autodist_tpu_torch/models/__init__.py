"""Model definitions of the port: the transformer families (BERT, the
causal LM, the pipelined LM, the MoE LM) and the model zoo of the
reference's examples and benchmarks (the MNIST CNN and linear
regression, ResNet, VGG, DenseNet, InceptionV3, NeuMF, the lm1b LSTM)."""

from autodist_tpu_torch.models.cnn import (MnistCNN, make_cnn_trainable,
                                           make_linear_regression_trainable)
from autodist_tpu_torch.models.densenet import (DenseNet, DenseNet121,
                                                DenseNet169, DenseNet201)
from autodist_tpu_torch.models.inception import InceptionV3
from autodist_tpu_torch.models.lm1b import (LSTMWordLM, make_lm1b_trainable,
                                            sampled_softmax_loss)
from autodist_tpu_torch.models.ncf import NeuMF, make_ncf_trainable
from autodist_tpu_torch.models.resnet import (ResNet18, ResNet34, ResNet50,
                                              ResNet101, ResNet152,
                                              classification_loss_head,
                                              make_image_trainable,
                                              make_resnet_trainable)
from autodist_tpu_torch.models.vgg import VGG, VGG11, VGG13, VGG16, VGG19
