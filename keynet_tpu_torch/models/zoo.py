"""Reference model zoo, declared as keynet_tpu_torch specs.

Architectures mirror the reference exactly so its shipped checkpoints load
bit-for-bit: LeNet / LeNet_AvgPool (keynet/mnist.py:11-63), AllConvNet with
optional batchnorm (keynet/cifar10.py:12-65), and the avgpool VGG-16 variant
(keynet/vgg.py:38-122).  Dataset normalization constants are carried along for
the training/validation recipes.
"""

from .specs import (Model, Conv2d, AvgPool2d, MaxPool2d, ReLU, Linear,
                    BatchNorm2d, Dropout)

MNIST_MEAN, MNIST_STD = 0.1307, 0.3081
CIFAR10_MEAN = (0.49139968, 0.48215841, 0.44653091)
CIFAR10_STD = (0.24703223, 0.24348513, 0.26158784)
# fiber-bundle-retrained normalization constants (reference demo/figures.py:153,204)
MNIST_FIBERBUNDLE_MEAN, MNIST_FIBERBUNDLE_STD = 0.46616146, 0.06223659
CIFAR10_FIBERBUNDLE_MEAN = (0.5865, 0.5805, 0.4803)
CIFAR10_FIBERBUNDLE_STD = (0.0866, 0.0983, 0.0473)
VGG16_BGR_MEAN = (93.5940, 104.7624, 129.1863)


def LeNet(in_channels=1, seed=0):
    """LeNet with MaxPool (NOT keyable — max is nonlinear; parity with
    keynet/mnist.py:11-46 where only the AvgPool variant is keyed)."""
    layers = [
        Conv2d("conv1", in_channels, 6, 3, stride=1),
        ReLU("relu1"),
        MaxPool2d("pool1", 3, 2, padding=1),
        Conv2d("conv2", 6, 16, 3, stride=1),
        ReLU("relu2"),
        MaxPool2d("pool2", 3, 2, padding=1),
        Linear("fc1", 16 * 7 * 7, 120),
        ReLU("relu3"),
        Linear("fc2", 120, 84),
        ReLU("relu4"),
        Linear("fc3", 84, 10),
    ]
    return Model(layers, inshape=(in_channels, 28, 28), seed=seed)


def LeNet_AvgPool(in_channels=1, seed=0):
    """The canonical keyable quickstart net (keynet/mnist.py:49-63)."""
    layers = [
        Conv2d("conv1", in_channels, 6, 3, stride=1),
        ReLU("relu1"),
        AvgPool2d("pool1", 3, 2),
        Conv2d("conv2", 6, 16, 3, stride=1),
        ReLU("relu2"),
        AvgPool2d("pool2", 3, 2),
        Linear("fc1", 7 * 7 * 16, 120),
        ReLU("relu3"),
        Linear("fc2", 120, 84),
        ReLU("relu4"),
        Linear("fc3", 84, 10),
    ]
    return Model(layers, inshape=(in_channels, 28, 28), seed=seed)


def AllConvNet(batchnorm=False, n_input_channels=3, n_classes=10, seed=0):
    """All-convolutional CIFAR-10 net, optional *_bn layers exercising the
    batchnorm-fusion naming convention (keynet/cifar10.py:12-65)."""
    layers = [Dropout("dropout0", 0.2),
              Conv2d("conv1", n_input_channels, 96, 3), ReLU("relu1"),
              Conv2d("conv2", 96, 96, 3), ReLU("relu2"),
              Conv2d("conv3", 96, 96, 3, stride=2)]
    if batchnorm:
        layers += [BatchNorm2d("conv3_bn", 96)]
    layers += [Dropout("dropout3", 0.5), ReLU("relu3"),
               Conv2d("conv4", 96, 192, 3), ReLU("relu4"),
               Conv2d("conv5", 192, 192, 3), ReLU("relu5"),
               Conv2d("conv6", 192, 192, 3, stride=2)]
    if batchnorm:
        layers += [BatchNorm2d("conv6_bn", 192)]
    layers += [Dropout("dropout6", 0.5), ReLU("relu6"),
               Conv2d("conv7", 192, 192, 3), ReLU("relu7"),
               Conv2d("conv8", 192, 192, 1), ReLU("relu8"),
               Conv2d("conv9", 192, n_classes, 1), ReLU("relu9"),
               Linear("fc1", n_classes * 8 * 8, 100), ReLU("relu10"),
               Linear("fc2", 100, 10)]
    return Model(layers, inshape=(n_input_channels, 32, 32), seed=seed)


def VGG16(num_classes=2622, seed=0):
    """VGG-16 with average pooling (keynet/vgg.py:38-122).  Pools use the
    Toeplitz-consistent centered/padded semantics (see models/specs.py)."""
    cfg = [("conv1_1", 3, 64), ("conv1_2", 64, 64), "pool1_2",
           ("conv2_1", 64, 128), ("conv2_2", 128, 128), "pool2_2",
           ("conv3_1", 128, 256), ("conv3_2", 256, 256), ("conv3_3", 256, 256), "pool3_3",
           ("conv4_1", 256, 512), ("conv4_2", 512, 512), ("conv4_3", 512, 512), "pool4_3",
           ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512), "pool5_3"]
    layers = []
    for item in cfg:
        if isinstance(item, tuple):
            name, cin, cout = item
            layers += [Conv2d(name, cin, cout, 3), ReLU("relu" + name[4:])]
        else:
            layers += [AvgPool2d(item, 3, 2)]
    layers += [Linear("fc6", 25088, 4096), ReLU("relu6"),
               Dropout("dropout7", 0.5), Linear("fc7", 4096, 4096), ReLU("relu7"),
               Dropout("dropout8", 0.5), Linear("fc8", 4096, num_classes)]
    return Model(layers, inshape=(3, 224, 224), seed=seed)


# ------------------------------------------------- VGG-16 image preprocessing

def prepare_vgg16_image(img):
    """Convert a resized/cropped RGB image (PIL or HxWx3 array) to the float
    CHW tensor the VGGFace checkpoint expects: RGB->BGR channel swap,
    mean-pixel subtraction (VGG16_BGR_MEAN), then HWC->CHW
    (reference keynet/vgg.py:9-20; returns numpy instead of a torch tensor).
    """
    import numpy as np
    arr = np.asarray(img, dtype=np.float32)
    assert arr.ndim == 3 and arr.shape[2] == 3, "expected HxWx3 RGB image"
    bgr = arr[..., [2, 1, 0]] - np.asarray(VGG16_BGR_MEAN, dtype=np.float32)
    return np.ascontiguousarray(np.rollaxis(bgr, 2, 0))


def vgg16_preprocess(jitter=False, blur_radius=None, blur_prob=1.0, rng=None):
    """Preprocessing pipeline for VGGFace evaluation through a keynet
    (reference keynet/vgg.py:23-35): resize shortest side to 256, then
    center-crop 224x224 (eval) or random-crop + random horizontal flip
    (``jitter=True``, train), optional Gaussian blur with probability
    ``blur_prob``, then prepare_vgg16_image.

    Returns a callable PIL.Image -> float32 (3,224,224) numpy array.
    PIL-native (no torchvision); the reference's blur branch referenced an
    undefined ``generate_random_blur`` (latent NameError, vgg.py:32) — here it
    is implemented as PIL GaussianBlur.  ``rng`` seeds the jitter/blur draws.
    """
    import numpy as np
    from PIL import Image, ImageFilter
    rng = rng if rng is not None else np.random.default_rng()

    def _apply(im):
        im = im.convert("RGB")
        w, h = im.size
        scale = 256.0 / min(w, h)                    # torchvision Resize(256)
        im = im.resize((max(1, round(w * scale)), max(1, round(h * scale))),
                       Image.BILINEAR)
        w, h = im.size
        if jitter:
            i = int(rng.integers(0, h - 224 + 1))
            j = int(rng.integers(0, w - 224 + 1))
            im = im.crop((j, i, j + 224, i + 224))
            if rng.random() < 0.5:
                im = im.transpose(Image.FLIP_LEFT_RIGHT)
        else:                                        # CenterCrop(224)
            i, j = (h - 224) // 2, (w - 224) // 2
            im = im.crop((j, i, j + 224, i + 224))
        if blur_radius is not None and blur_prob > 0 and rng.random() < blur_prob:
            im = im.filter(ImageFilter.GaussianBlur(radius=blur_radius))
        return prepare_vgg16_image(im)

    return _apply
