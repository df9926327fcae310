from . import protocol, receiver, streamer
