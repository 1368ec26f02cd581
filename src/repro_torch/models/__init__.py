"""The port's models: the layers, the RWKV6 block, the layer stack and
``build_model`` for the dense and ssm families."""
