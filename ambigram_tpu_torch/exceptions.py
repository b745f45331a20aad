"""Typed exceptions (reference include/Exceptions.hpp:16-101)."""


class AmbigramError(Exception):
    pass


class DuplicateJunctionError(AmbigramError):
    def __init__(self, junction):
        super().__init__("duplicate junction: %s %s" % junction.info())
        self.junction = junction


class SegmentDoesNotExistError(AmbigramError, KeyError):
    def __init__(self, seg_id):
        super().__init__("segment %s does not exist" % seg_id)
        self.seg_id = seg_id


class JunctionDoesNotExistError(AmbigramError):
    pass


class ILPBalancerInfeasibleError(AmbigramError):
    pass


class BackwardReachSourceNegativeError(AmbigramError):
    pass


class BackwardReachSinkPositiveError(AmbigramError):
    pass


class ForwardReachSinkNegativeError(AmbigramError):
    pass


class ForwardReachSourcePositiveError(AmbigramError):
    pass
