"""Model stacks of the port (counterpart of ``repro.models``): so far the
recsys Factorization Machine.  Every model follows the reference's
functional contract — ``init``, ``forward`` / ``loss_fn`` as functions of
(params dict, batch), ``param_axes`` — with params as torch tensors."""
