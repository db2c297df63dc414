"""Plain PyTorch references of the configurations' models, one module a
family of models, named by a configuration file's ``reference`` key."""
