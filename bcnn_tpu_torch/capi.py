"""C-style API surface: function-per-operation names mirroring
inc/bcnn/bcnn.h, for users porting code from the reference verbatim; the
port of `bcnn_tpu.capi`.

    from bcnn_tpu_torch.capi import *

    net = bcnn_init_net(BCNN_MODE_TRAIN)      # device="cpu" for the CPU
    bcnn_set_input_shape(net, 28, 28, 1, 16)
    bcnn_add_convolutional_layer(net, 32, 3, 1, 1, 1, 1,
                                 BCNN_FILLER_XAVIER, BCNN_ACT_RELU, 0,
                                 "input", "conv1")
    ...
    bcnn_compile_net(net)
    loss = bcnn_train_on_batch(net)

The `net` handle is a Session whose graph-building calls forward to the
Net; mode/loader/weights functions map 1:1 to the reference's. The
Session runs on the card unless `bcnn_init_net` is given device="cpu".
"""

from __future__ import annotations

from .api import Session
from .graph import Net
from .types import (
    Activation,
    FillerType,
    LoaderType,
    LogLevel,
    Loss,
    LrDecay,
    Metric,
    Mode,
    Optimizer,
    Padding,
)

# enum aliases with reference spellings
BCNN_MODE_PREDICT = Mode.PREDICT
BCNN_MODE_TRAIN = Mode.TRAIN
BCNN_MODE_VALID = Mode.VALID
BCNN_FILLER_FIXED = FillerType.FIXED
BCNN_FILLER_XAVIER = FillerType.XAVIER
BCNN_FILLER_MSRA = FillerType.MSRA
BCNN_ACT_NONE = Activation.NONE
BCNN_ACT_TANH = Activation.TANH
BCNN_ACT_RELU = Activation.RELU
BCNN_ACT_RAMP = Activation.RAMP
BCNN_ACT_SOFTPLUS = Activation.SOFTPLUS
BCNN_ACT_LRELU = Activation.LRELU
BCNN_ACT_ABS = Activation.ABS
BCNN_ACT_CLAMP = Activation.CLAMP
BCNN_ACT_PRELU = Activation.PRELU
BCNN_ACT_LOGISTIC = Activation.LOGISTIC
BCNN_LOSS_EUCLIDEAN = Loss.EUCLIDEAN
BCNN_LOSS_LIFTED_STRUCT = Loss.LIFTED_STRUCT
BCNN_METRIC_ERROR_RATE = Metric.ERROR_RATE
BCNN_METRIC_LOGLOSS = Metric.LOGLOSS
BCNN_METRIC_SSE = Metric.SSE
BCNN_METRIC_MSE = Metric.MSE
BCNN_METRIC_CRPS = Metric.CRPS
BCNN_METRIC_DICE = Metric.DICE
BCNN_PADDING_SAME = Padding.SAME
BCNN_PADDING_VALID = Padding.VALID
BCNN_PADDING_CAFFE = Padding.CAFFE
BCNN_OPTIM_SGD = Optimizer.SGD
BCNN_OPTIM_ADAM = Optimizer.ADAM
BCNN_LR_DECAY_CONSTANT = LrDecay.CONSTANT
BCNN_LR_DECAY_STEP = LrDecay.STEP
BCNN_LR_DECAY_INV = LrDecay.INV
BCNN_LR_DECAY_EXP = LrDecay.EXP
BCNN_LR_DECAY_POLY = LrDecay.POLY
BCNN_LR_DECAY_SIGMOID = LrDecay.SIGMOID
BCNN_LOAD_MNIST = LoaderType.MNIST
BCNN_LOAD_CIFAR10 = LoaderType.CIFAR10
BCNN_LOAD_CLASSIFICATION_LIST = LoaderType.CLASSIFICATION_LIST
BCNN_LOAD_REGRESSION_LIST = LoaderType.REGRESSION_LIST
BCNN_LOAD_DETECTION_LIST = LoaderType.DETECTION_LIST


def bcnn_init_net(mode: Mode, device="cuda") -> Session:
    return Session(Net(mode), device=device)


def bcnn_end_net(net: Session):
    if net.loader is not None:
        net.loader.close()


def bcnn_set_input_shape(net: Session, w, h, c, batch_size):
    net.net.set_input_shape(w, h, c, batch_size)


def bcnn_add_input(net: Session, w, h, c, name):
    return net.net.add_input(w, h, c, name)


def bcnn_set_mode(net: Session, mode):
    net.set_mode(mode)


def bcnn_set_sgd_optimizer(net: Session, learning_rate, momentum):
    net.net.set_sgd_optimizer(learning_rate, momentum)


def bcnn_set_adam_optimizer(net: Session, learning_rate, beta1=0.9,
                            beta2=0.999):
    net.net.set_adam_optimizer(learning_rate, beta1, beta2)


def bcnn_set_learning_rate_policy(net: Session, decay_type, gamma, scale,
                                  power, max_batches, step):
    net.net.set_learning_rate_policy(
        decay_type, gamma, scale, power, max_batches, step
    )


def bcnn_set_weight_regularizer(net: Session, weight_decay):
    net.net.set_weight_regularizer(weight_decay)


def bcnn_set_num_threads(net: Session, n):
    net.net.set_num_threads(n)


def bcnn_add_convolutional_layer(net, n, size, stride, pad, num_groups,
                                 batch_norm, init, activation, quantize,
                                 src_id, dst_id):
    net.net.add_convolutional_layer(
        n, size, stride, pad, num_groups, batch_norm, init, activation,
        quantize, src_id, dst_id,
    )


def bcnn_add_deconvolutional_layer(net, n, size, stride, pad, init,
                                   activation, src_id, dst_id):
    net.net.add_deconvolutional_layer(
        n, size, stride, pad, init, activation, src_id, dst_id
    )


def bcnn_add_depthwise_conv_layer(net, size, stride, pad, batch_norm, init,
                                  activation, src_id, dst_id):
    net.net.add_depthwise_conv_layer(
        size, stride, pad, batch_norm, init, activation, src_id, dst_id
    )


def bcnn_add_batchnorm_layer(net, src_id, dst_id):
    net.net.add_batchnorm_layer(src_id, dst_id)


def bcnn_add_lrn_layer(net, local_size, alpha, beta, k, src_id, dst_id):
    net.net.add_lrn_layer(local_size, alpha, beta, k, src_id, dst_id)


def bcnn_add_fullc_layer(net, output_size, init, activation, quantize,
                         src_id, dst_id):
    net.net.add_fullc_layer(
        output_size, init, activation, quantize, src_id, dst_id
    )


def bcnn_add_activation_layer(net, type, id):
    net.net.add_activation_layer(type, id)


def bcnn_add_softmax_layer(net, src_id, dst_id):
    net.net.add_softmax_layer(src_id, dst_id)


def bcnn_add_maxpool_layer(net, size, stride, padding, src_id, dst_id):
    net.net.add_maxpool_layer(size, stride, padding, src_id, dst_id)


def bcnn_add_avgpool_layer(net, src_id, dst_id):
    net.net.add_avgpool_layer(src_id, dst_id)


def bcnn_add_concat_layer(net, num_src, src_ids, dst_id=None):
    # reference signature is (net, num_src, src_ids, dst_id); also accept
    # (net, src_ids, dst_id)
    if dst_id is None:
        src_ids, dst_id = num_src, src_ids
    else:
        src_ids = list(src_ids)[:num_src]
    net.net.add_concat_layer(src_ids, dst_id)


def bcnn_add_eltwise_layer(net, activation, src_id1, src_id2, dst_id):
    net.net.add_eltwise_layer(activation, src_id1, src_id2, dst_id)


def bcnn_add_dropout_layer(net, rate, id):
    net.net.add_dropout_layer(rate, id)


def bcnn_add_upsample_layer(net, size, src_id, dst_id):
    net.net.add_upsample_layer(size, src_id, dst_id)


def bcnn_add_yolo_layer(net, num_boxes_per_cell, classes, coords, total,
                        mask, anchors, src_id, dst_id):
    net.net.add_yolo_layer(
        num_boxes_per_cell, classes, coords, total, mask, anchors,
        src_id, dst_id,
    )


def bcnn_add_cost_layer(net, loss, loss_metric, scale, src_id, label_id,
                        dst_id):
    net.net.add_cost_layer(loss, loss_metric, scale, src_id, label_id, dst_id)


def bcnn_set_data_loader(net, type, train_path_data, train_path_extra=None,
                         test_path_data=None, test_path_extra=None):
    net.set_data_loader(
        type, train_path_data, train_path_extra, test_path_data,
        test_path_extra,
    )


def bcnn_compile_net(net: Session):
    net.compile_net()


def bcnn_forward(net: Session):
    return net.forward()


def bcnn_backward(net: Session):
    return net.backward()


def bcnn_update(net: Session):
    return net.update()


def bcnn_get_batch_size(net: Session):
    return net.get_batch_size()


def bcnn_get_num_threads(net: Session):
    return net.get_num_threads()


def bcnn_get_tensor_index_by_name(net: Session, name):
    return net.net.get_tensor_index_by_name(name)


def bcnn_get_tensor_by_name(net: Session, name):
    try:
        return net.get_tensor(name)  # params / running stats
    except KeyError:
        return net.get_tensor_value(name)  # activations from last forward


def bcnn_get_tensor_by_index(net: Session, index):
    return bcnn_get_tensor_by_name(net, net.net.tensors[index].name)


def bcnn_fill_tensor_with_image(net: Session, img, w, h, c, norm_coeff,
                                swap_to_bgr, mean_r, mean_g, mean_b,
                                tensor_index, batch_index, x_buffer):
    import numpy as _np

    return net.fill_tensor_with_image(
        _np.asarray(img, _np.uint8).reshape(h, w, c), batch_index, x_buffer,
        norm_coeff, swap_to_bgr, mean_r, mean_g, mean_b,
    )


def bcnn_train_on_batch(net: Session):
    return float(net.train_on_batch())


def bcnn_predict_on_batch(net: Session):
    outs, loss = net.predict_on_batch()
    return outs[0], float(loss)


def bcnn_save_weights(net: Session, filename):
    net.save_weights(filename)


def bcnn_load_weights(net: Session, filename):
    net.load_weights(filename)


def bcnn_load_net(net: Session, config_path, model_path=None):
    from .config import load_net

    load_net(net.net, config_path, model_path)


def bcnn_resize_net(net: Session, w, h, c=None, need_realloc=1):
    net.net.resize(w, h, c)
    net.compile_net()


def bcnn_yolo_get_detections(net: Session, x, w, h, netw, neth, thresh,
                             relative=1, batch=0):
    return net.yolo_get_detections(
        x, w, h, netw, neth, thresh, relative, batch
    )


def bcnn_set_log_context(callback=None, level=LogLevel.INFO):
    from .log import set_log_context

    return set_log_context(callback, level)


# augmentation setters (bcnn.h data augmentation API)
def bcnn_augment_data_with_shift(net, width_shift_range, height_shift_range):
    net.net.data_aug["range_shift_x"] = width_shift_range
    net.net.data_aug["range_shift_y"] = height_shift_range


def bcnn_augment_data_with_rotation(net, rotation_range):
    net.net.data_aug["rotation_range"] = rotation_range


def bcnn_augment_data_with_scale(net, min_scale, max_scale):
    net.net.data_aug["min_scale"] = min_scale
    net.net.data_aug["max_scale"] = max_scale


def bcnn_augment_data_with_flip(net, horizontal_flip=1):
    net.net.data_aug["random_fliph"] = int(horizontal_flip)


def bcnn_augment_data_with_color_adjustment(net, min_brightness,
                                            max_brightness, min_contrast,
                                            max_contrast):
    net.net.data_aug.update(
        min_brightness=min_brightness, max_brightness=max_brightness,
        min_contrast=min_contrast, max_contrast=max_contrast,
    )


def bcnn_augment_data_with_blobs(net, max_blobs):
    net.net.data_aug["max_random_spots"] = max_blobs


def bcnn_augment_data_with_distortion(net, distortion):
    net.net.data_aug["max_distortion"] = distortion
