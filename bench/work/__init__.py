"""Work counts from shapes: the operations and bytes of a kernel op's
call (``kernels``), the operations of a model's step (one module a
``model_type``), and the card's published peaks (``peaks``)."""
