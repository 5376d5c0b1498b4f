"""forward_ms.grad: api.image_loss as the grad step calls it (the accel
built from the parameters, render_tiled and the loss), ms a step, mean over
the window's steps."""
SPANS = {"image_loss": "tracer_torch.api:image_loss"}


def read(t):
    return t.per_unit_ms("image_loss")
