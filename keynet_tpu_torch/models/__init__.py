from .specs import (Model, Conv2d, AvgPool2d, GlobalAvgPool2d, MaxPool2d, ReLU,
                    Linear, BatchNorm2d, Dropout)
from .zoo import (LeNet, LeNet_AvgPool, AllConvNet, VGG16, ResNet34A, ResNetA,
                  prepare_vgg16_image, vgg16_preprocess, VGG16_BGR_MEAN,
                  MNIST_MEAN, MNIST_STD, CIFAR10_MEAN, CIFAR10_STD)
