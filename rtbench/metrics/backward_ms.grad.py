"""backward_ms.grad: the grad step's stream time less its api.image_loss
span, ms a step: zeroing the gradients, the normals from the vertices,
autograd's backward and the Adam update."""
SPANS = {"image_loss": "tracer_torch.api:image_loss"}


def read(t):
    step, loss = t.per_unit_ms("unit"), t.per_unit_ms("image_loss")
    return None if step is None or loss is None else step - loss
