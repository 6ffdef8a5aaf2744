"""Device kernels a training iteration: the kernels that started inside the
traced window's whole ``learn iteration`` spans, over those spans' number."""


def read(ctx):
    tr = ctx.get('trace')
    if tr is None:
        return None
    n, iters = tr.kernels_in('learn iteration')
    if iters == 0 or n == 0:
        return None
    return n / iters
