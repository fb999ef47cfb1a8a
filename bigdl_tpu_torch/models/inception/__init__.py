"""Inception v1 and v2 for ImageNet
(``bigdl_tpu/models/inception/__init__.py``: ``inception_layer_v1`` :25,
``inception_v1_no_aux_classifier`` :79, ``inception_v1`` :103,
``inception_layer_v2`` :167, ``inception_v2_no_aux_classifier`` :244,
``inception_v2`` :256; reference ``models/inception/Inception_v1.scala:102``,
``Inception_v2.scala:152``).

The builders keep the JAX package's module tree, towers nested in
``Concat(2)`` included, so its parameter and state trees carry over with
:func:`bigdl_tpu_torch.utils.convert.params_from_jax` and
:func:`~bigdl_tpu_torch.utils.convert.state_from_jax`.  Channels-last by
default (``layout="NHWC"``, :mod:`bigdl_tpu_torch.nn.layout`): the trunk,
the towers, their channel concats and the auxiliary heads' pools compute
channels-last; the input stays an NCHW batch of 224 x 224 images.  Initial
weights come from one CPU generator seeded with ``seed``, drawn in module
order; Inception-v1's convolutions are then drawn again with ``Xavier`` and
``Zeros`` (the auxiliary heads' 1 x 1 convolutions keep the default
uniform draw), as the JAX package's ``_conv`` sets them.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import nn
from bigdl_tpu_torch.engine import DeviceLike, default_device
from bigdl_tpu_torch.nn.module import make_generator


class _Layers:
    """Layer constructors that share one device and one generator."""

    def __init__(self, device: DeviceLike,
                 generator: Optional[torch.Generator]):
        self.g = make_generator(generator)
        self.kw = dict(device=default_device(device), generator=self.g)

    def conv(self, n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0,
             propagate_back=True, xavier=True) -> nn.SpatialConvolution:
        c = nn.SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph, 1,
                                  propagate_back, **self.kw)
        if xavier:
            c.set_init_method(nn.Xavier(), nn.Zeros(), generator=self.g)
        return c

    def conv_bn(self, seq, n_in, n_out, kw, kh, sw=1, sh=1, pw=0, ph=0,
                propagate_back=True) -> None:
        seq.add(nn.SpatialConvolution(n_in, n_out, kw, kh, sw, sh, pw, ph, 1,
                                      propagate_back, **self.kw))
        seq.add(nn.SpatialBatchNormalization(n_out, 1e-3, **self.kw))
        seq.add(nn.ReLU())

    def linear(self, n_in, n_out) -> nn.Linear:
        return nn.Linear(n_in, n_out, **self.kw)


def _tower(*modules) -> nn.Sequential:
    s = nn.Sequential()
    for m in modules:
        s.add(m)
    return s


def inception_layer_v1(input_size: int, config, device: DeviceLike = "cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Concat:
    """One GoogLeNet block: 1x1 / 3x3 / 5x5 / pool-projection towers
    concatenated along the channels.  ``config = ((c1,), (r3, c3),
    (r5, c5), (cp,))``.  NCHW; the builders convert whole models."""
    return _layer_v1(_Layers(device, generator), input_size, config)


def _layer_v1(L: _Layers, input_size: int, config) -> nn.Concat:
    return (nn.Concat(2)
            .add(_tower(L.conv(input_size, config[0][0], 1, 1), nn.ReLU()))
            .add(_tower(L.conv(input_size, config[1][0], 1, 1), nn.ReLU(),
                        L.conv(config[1][0], config[1][1], 3, 3, 1, 1, 1, 1),
                        nn.ReLU()))
            .add(_tower(L.conv(input_size, config[2][0], 1, 1), nn.ReLU(),
                        L.conv(config[2][0], config[2][1], 5, 5, 1, 1, 2, 2),
                        nn.ReLU()))
            .add(_tower(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil(),
                        L.conv(input_size, config[3][0], 1, 1), nn.ReLU())))


_V1_4BCD = ((512, ((160,), (112, 224), (24, 64), (64,))),
            (512, ((128,), (128, 256), (24, 64), (64,))),
            (512, ((112,), (144, 288), (32, 64), (64,))))
_V1_4E = (528, ((256,), (160, 320), (32, 128), (128,)))
_V1_5AB = ((832, ((256,), (160, 320), (32, 128), (128,))),
           (832, ((384,), (192, 384), (48, 128), (128,))))


def _v1_stem(L: _Layers) -> nn.Sequential:
    f = nn.Sequential()
    f.add(L.conv(3, 64, 7, 7, 2, 2, 3, 3, propagate_back=False))
    f.add(nn.ReLU())
    f.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    f.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    f.add(L.conv(64, 64, 1, 1))
    f.add(nn.ReLU())
    f.add(L.conv(64, 192, 3, 3, 1, 1, 1, 1))
    f.add(nn.ReLU())
    f.add(nn.SpatialCrossMapLRN(5, 0.0001, 0.75))
    f.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    f.add(_layer_v1(L, 192, ((64,), (96, 128), (16, 32), (32,))))
    f.add(_layer_v1(L, 256, ((128,), (128, 192), (32, 96), (64,))))
    f.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    f.add(_layer_v1(L, 480, ((192,), (96, 208), (16, 48), (64,))))
    return f


def _v1_head(L: _Layers, m: nn.Sequential, class_num: int) -> nn.Sequential:
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1))
    m.add(nn.Dropout(0.4))
    m.add(nn.View(1024).set_num_input_dims(3))
    m.add(L.linear(1024, class_num))
    m.add(nn.LogSoftMax())
    return m


def inception_v1_no_aux_classifier(class_num: int = 1000,
                                   layout: str = "NHWC",
                                   device: DeviceLike = "cuda",
                                   seed: int = 0) -> nn.Sequential:
    """GoogLeNet without its auxiliary heads: 224 x 224 images in,
    ``class_num`` log-probabilities out."""
    L = _Layers(device, torch.Generator().manual_seed(seed))
    m = _v1_stem(L)
    for size, cfg in _V1_4BCD + (_V1_4E,):
        m.add(_layer_v1(L, size, cfg))
    m.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for size, cfg in _V1_5AB:
        m.add(_layer_v1(L, size, cfg))
    return nn.apply_layout(_v1_head(L, m, class_num), layout)


def _v1_aux(L: _Layers, pool: nn.SpatialAveragePooling, n_in: int,
            class_num: int) -> nn.Sequential:
    return _tower(pool, L.conv(n_in, 128, 1, 1, xavier=False), nn.ReLU(),
                  nn.View(128 * 4 * 4).set_num_input_dims(3),
                  L.linear(128 * 4 * 4, 1024), nn.ReLU(), nn.Dropout(0.7),
                  L.linear(1024, class_num), nn.LogSoftMax())


def inception_v1(class_num: int = 1000, layout: str = "NHWC",
                 device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """Full GoogLeNet with the two auxiliary heads; the output is the
    channel concat of [main, aux2, aux1] log-probabilities, (N, 3 *
    class_num) (reference ``Inception_v1.scala:104-186``)."""
    L = _Layers(device, torch.Generator().manual_seed(seed))
    feature1 = _v1_stem(L)
    output1 = _v1_aux(L, nn.SpatialAveragePooling(5, 5, 3, 3).ceil(), 512,
                      class_num)
    feature2 = nn.Sequential()
    for size, cfg in _V1_4BCD:
        feature2.add(_layer_v1(L, size, cfg))
    output2 = _v1_aux(L, nn.SpatialAveragePooling(5, 5, 3, 3), 528,
                      class_num)
    output3 = nn.Sequential().add(_layer_v1(L, *_V1_4E))
    output3.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    for size, cfg in _V1_5AB:
        output3.add(_layer_v1(L, size, cfg))
    _v1_head(L, output3, class_num)
    split2 = nn.Concat(2).add(output3).add(output2)
    main_branch = nn.Sequential().add(feature2).add(split2)
    split1 = nn.Concat(2).add(main_branch).add(output1)
    return nn.apply_layout(nn.Sequential().add(feature1).add(split1), layout)


def inception_layer_v2(input_size: int, config, device: DeviceLike = "cuda",
                       generator: Optional[torch.Generator] = None
                       ) -> nn.Concat:
    """BN-Inception block.  ``config = ((c1,), (r3, c3), (r33, c33),
    (pool_kind, cp))``, ``pool_kind`` "max" or "avg"; c1 == 0 drops the 1x1
    tower, and the 3x3 towers stride 2 when cp == 0 under max pooling
    (reference ``Inception_v2.scala:27-115``).  NCHW."""
    return _layer_v2(_Layers(device, generator), input_size, config)


def _layer_v2(L: _Layers, input_size: int, config) -> nn.Concat:
    concat = nn.Concat(2)
    pool_kind, cp = config[3]
    stride = 2 if pool_kind == "max" and cp == 0 else 1
    if config[0][0] != 0:
        conv1 = nn.Sequential()
        L.conv_bn(conv1, input_size, config[0][0], 1, 1)
        concat.add(conv1)
    conv3 = nn.Sequential()
    L.conv_bn(conv3, input_size, config[1][0], 1, 1)
    L.conv_bn(conv3, config[1][0], config[1][1], 3, 3, stride, stride, 1, 1)
    concat.add(conv3)
    conv33 = nn.Sequential()
    L.conv_bn(conv33, input_size, config[2][0], 1, 1)
    L.conv_bn(conv33, config[2][0], config[2][1], 3, 3, 1, 1, 1, 1)
    L.conv_bn(conv33, config[2][1], config[2][1], 3, 3, stride, stride, 1, 1)
    concat.add(conv33)
    pool = nn.Sequential()
    if pool_kind == "max":
        pool.add(nn.SpatialMaxPooling(3, 3, 1, 1, 1, 1).ceil() if cp != 0
                 else nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    elif pool_kind == "avg":
        pool.add(nn.SpatialAveragePooling(3, 3, 1, 1, 1, 1, ceil_mode=True))
    else:
        raise ValueError(pool_kind)
    if cp != 0:
        L.conv_bn(pool, input_size, cp, 1, 1)
    concat.add(pool)
    return concat


_V2_BLOCKS_3 = [
    (192, ((64,), (64, 64), (64, 96), ("avg", 32))),
    (256, ((64,), (64, 96), (64, 96), ("avg", 64))),
    (320, ((0,), (128, 160), (64, 96), ("max", 0))),
]
_V2_BLOCKS_4 = [
    (576, ((224,), (64, 96), (96, 128), ("avg", 128))),
    (576, ((192,), (96, 128), (96, 128), ("avg", 128))),
    (576, ((160,), (128, 160), (128, 160), ("avg", 96))),
    (576, ((96,), (128, 192), (160, 192), ("avg", 96))),
    (576, ((0,), (128, 192), (192, 256), ("max", 0))),
]
_V2_BLOCKS_5 = [
    (1024, ((352,), (192, 320), (160, 224), ("avg", 128))),
    (1024, ((352,), (192, 320), (192, 224), ("max", 128))),
]


def _v2_stem(L: _Layers) -> nn.Sequential:
    f = nn.Sequential()
    L.conv_bn(f, 3, 64, 7, 7, 2, 2, 3, 3, propagate_back=False)
    f.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    L.conv_bn(f, 64, 64, 1, 1)
    L.conv_bn(f, 64, 192, 3, 3, 1, 1, 1, 1)
    f.add(nn.SpatialMaxPooling(3, 3, 2, 2).ceil())
    return f


def _v2_head(L: _Layers, m: nn.Sequential, class_num: int) -> nn.Sequential:
    m.add(nn.SpatialAveragePooling(7, 7, 1, 1, ceil_mode=True))
    m.add(nn.View(1024).set_num_input_dims(3))
    m.add(L.linear(1024, class_num))
    m.add(nn.LogSoftMax())
    return m


def inception_v2_no_aux_classifier(class_num: int = 1000,
                                   layout: str = "NHWC",
                                   device: DeviceLike = "cuda",
                                   seed: int = 0) -> nn.Sequential:
    """BN-Inception without its auxiliary heads."""
    L = _Layers(device, torch.Generator().manual_seed(seed))
    m = _v2_stem(L)
    for size, cfg in _V2_BLOCKS_3 + _V2_BLOCKS_4 + _V2_BLOCKS_5:
        m.add(_layer_v2(L, size, cfg))
    return nn.apply_layout(_v2_head(L, m, class_num), layout)


def _v2_aux(L: _Layers, n_in: int, side: int,
            class_num: int) -> nn.Sequential:
    out = nn.Sequential().add(
        nn.SpatialAveragePooling(5, 5, 3, 3, ceil_mode=True))
    L.conv_bn(out, n_in, 128, 1, 1)
    return (out.add(nn.View(128 * side * side).set_num_input_dims(3))
            .add(L.linear(128 * side * side, 1024)).add(nn.ReLU())
            .add(L.linear(1024, class_num)).add(nn.LogSoftMax()))


def inception_v2(class_num: int = 1000, layout: str = "NHWC",
                 device: DeviceLike = "cuda", seed: int = 0) -> nn.Sequential:
    """BN-Inception with its two auxiliary heads; the output is the
    channel concat of [main, aux2, aux1] log-probabilities."""
    L = _Layers(device, torch.Generator().manual_seed(seed))
    features1 = _v2_stem(L)
    for size, cfg in _V2_BLOCKS_3:
        features1.add(_layer_v2(L, size, cfg))
    output1 = _v2_aux(L, 576, 4, class_num)
    features2 = nn.Sequential()
    for size, cfg in _V2_BLOCKS_4:
        features2.add(_layer_v2(L, size, cfg))
    output2 = _v2_aux(L, 1024, 2, class_num)
    output3 = nn.Sequential()
    for size, cfg in _V2_BLOCKS_5:
        output3.add(_layer_v2(L, size, cfg))
    _v2_head(L, output3, class_num)
    split2 = nn.Concat(2).add(output3).add(output2)
    main_branch = nn.Sequential().add(features2).add(split2)
    split1 = nn.Concat(2).add(main_branch).add(output1)
    return nn.apply_layout(nn.Sequential().add(features1).add(split1), layout)
