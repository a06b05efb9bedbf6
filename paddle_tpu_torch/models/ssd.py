"""MobileNet-v1 SSD detector (reference: the fluid object_detection
benchmark — models/fluid/PaddleCV object_detection mobilenet_ssd.py — on
PASCAL VOC), the port's copy of ``paddle_tpu/models/ssd.py``.

Depthwise-separable convs are grouped convolutions; six detection
feature maps feed ``multi_box_head``; training uses the fused
``ssd_loss`` (match, mining, assignment and losses inside the step) and
the test Program, cloned before RMSProp, ``detection_output`` (decode
and multiclass NMS on the device).
"""
from __future__ import annotations

from .. import layers, optimizer as optim
from ..layers import detection

NUM_CLASSES = 21
IMG_SHAPE = [3, 300, 300]


def conv_bn(input, num_filters, filter_size, stride, padding, num_groups=1, act="relu"):
    conv = layers.conv2d(
        input=input,
        num_filters=num_filters,
        filter_size=filter_size,
        stride=stride,
        padding=padding,
        groups=num_groups,
        act=None,
        bias_attr=False,
    )
    return layers.batch_norm(input=conv, act=act)


def depthwise_separable(input, num_filters1, num_filters2, num_groups, stride, scale):
    dw = conv_bn(input, int(num_filters1 * scale), 3, stride, 1, num_groups=int(num_groups * scale))
    return conv_bn(dw, int(num_filters2 * scale), 1, 1, 0)


def extra_block(input, num_filters1, num_filters2, num_groups, stride, scale):
    pointwise = conv_bn(input, int(num_filters1 * scale), 1, 1, 0)
    return conv_bn(pointwise, int(num_filters2 * scale), 3, stride, 1)


def mobile_net(img, img_shape, scale=1.0):
    tmp = conv_bn(img, int(32 * scale), 3, 2, 1)  # 300 -> 150
    tmp = depthwise_separable(tmp, 32, 64, 32, 1, scale)
    tmp = depthwise_separable(tmp, 64, 128, 64, 2, scale)  # -> 75
    tmp = depthwise_separable(tmp, 128, 128, 128, 1, scale)
    tmp = depthwise_separable(tmp, 128, 256, 128, 2, scale)  # -> 38
    tmp = depthwise_separable(tmp, 256, 256, 256, 1, scale)
    tmp = depthwise_separable(tmp, 256, 512, 256, 2, scale)  # -> 19
    for _ in range(5):
        tmp = depthwise_separable(tmp, 512, 512, 512, 1, scale)
    module11 = tmp  # 19x19
    tmp = depthwise_separable(tmp, 512, 1024, 512, 2, scale)  # -> 10
    module13 = depthwise_separable(tmp, 1024, 1024, 1024, 1, scale)
    module14 = extra_block(module13, 256, 512, 1, 2, scale)  # -> 5
    module15 = extra_block(module14, 128, 256, 1, 2, scale)  # -> 3
    module16 = extra_block(module15, 128, 256, 1, 2, scale)  # -> 2
    module17 = extra_block(module16, 64, 128, 1, 2, scale)  # -> 1
    return module11, module13, module14, module15, module16, module17


def build_mobilenet_ssd(img, num_classes, img_shape, scale=1.0):
    feats = mobile_net(img, img_shape, scale)
    mbox_locs, mbox_confs, box, box_var = detection.multi_box_head(
        inputs=list(feats),
        image=img,
        num_classes=num_classes,
        min_ratio=20,
        max_ratio=90,
        aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0]],
        base_size=img_shape[2],
        offset=0.5,
        flip=True,
    )
    return mbox_locs, mbox_confs, box, box_var


def get_model(batch_size=32, num_classes=NUM_CLASSES, img_shape=None, lr=1e-3, scale=1.0, max_gt=20):
    import paddle_tpu_torch as fluid

    img_shape = list(img_shape or IMG_SHAPE)
    main = fluid.Program()
    startup = fluid.Program()
    with fluid.program_guard(main, startup):
        image = layers.data(name="image", shape=img_shape, dtype="float32")
        gt_box = layers.data(name="gt_box", shape=[4], lod_level=1, dtype="float32")
        gt_label = layers.data(name="gt_label", shape=[1], lod_level=1, dtype="int64")
        locs, confs, box, box_var = build_mobilenet_ssd(image, num_classes, img_shape, scale)
        loss = detection.ssd_loss(locs, confs, gt_box, gt_label, box, box_var)
        loss = layers.reduce_sum(loss)
        nmsed_out = detection.detection_output(locs, confs, box, box_var, nms_threshold=0.45)
        inference_program = main.clone(for_test=True)
        optim.RMSPropOptimizer(learning_rate=lr).minimize(loss)
    return {
        "main": main,
        "startup": startup,
        "test": inference_program,
        "feeds": ["image", "gt_box", "gt_label"],
        "loss": loss,
        "nmsed_out": nmsed_out,
    }
