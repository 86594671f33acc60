"""Resize ops on NHWC tensors."""


def upsample_nearest_2x(x):
    """(N,H,W,C) -> (N,2H,2W,C), nearest neighbour (mxnet ``UpSampling``)."""
    n, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(n, h, 2, w, 2, c)
    return x.reshape(n, 2 * h, 2 * w, c)
