"""The optional architectures the benchmark's configurations do not use."""


class _Absent:
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(f"{type(self).__name__} is not part of the frozen reference")


class Encoder(_Absent):
    pass


class FeatureVolume(_Absent):
    pass


class SynthesisLayer3(_Absent):
    pass
