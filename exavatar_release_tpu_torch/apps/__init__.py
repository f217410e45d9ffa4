"""Applications on the avatar: the CLIs ``train``, ``test``, ``evaluate`` and
``animate`` on a subject directory, the training loop and motion rendering."""
