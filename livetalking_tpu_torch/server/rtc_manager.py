"""WebRTC signaling (ports livetalking_tpu/server/rtc_manager.py): /offer
handling and WHIP (rtcpush) dial-out.

Create the session on /offer, build an RTCPeerConnection with the
configured STUN server, attach the HumanPlayer tracks, prefer H264 > VP8 >
rtx, tear the session down when the connection fails or closes (the player
stops in an executor, then the session is removed); answer
``{sdp, type, sessionid}``, or ``{code: -1, msg}`` on error.
``handle_rtcpush`` dials a WHIP endpoint (e.g. SRS) and pushes the
session's media.
"""

from __future__ import annotations

import asyncio
import json
from typing import Set

import aiohttp
from aiohttp import web
from aiortc import (
    RTCConfiguration,
    RTCIceServer,
    RTCPeerConnection,
    RTCSessionDescription,
)
from aiortc.rtcrtpsender import RTCRtpSender

from livetalking_tpu_torch.server.session_manager import session_manager
from livetalking_tpu_torch.server.webrtc import HumanPlayer
from livetalking_tpu_torch.utils.logger import logger


def _prefer_codecs(pc: RTCPeerConnection) -> None:
    """H264 > VP8 > rtx on the video transceiver."""
    capabilities = RTCRtpSender.getCapabilities("video")
    preferences = [c for c in capabilities.codecs if c.mimeType == "video/H264"]
    preferences += [c for c in capabilities.codecs if c.mimeType == "video/VP8"]
    preferences += [c for c in capabilities.codecs if c.mimeType == "video/rtx"]
    for t in pc.getTransceivers():
        if t.kind == "video":
            t.setCodecPreferences(preferences)


class RTCManager:
    def __init__(self, opt):
        self.opt = opt
        self.pcs: Set[RTCPeerConnection] = set()

    def _make_pc(self) -> RTCPeerConnection:
        if self.opt.stun:
            config = RTCConfiguration(iceServers=[RTCIceServer(urls=[self.opt.stun])])
            return RTCPeerConnection(configuration=config)
        return RTCPeerConnection()

    async def handle_offer(self, request: web.Request) -> web.Response:
        try:
            params = await request.json()
            offer = RTCSessionDescription(sdp=params["sdp"], type=params["type"])

            sessionid = await session_manager.create_session(params)
            avatar_session = session_manager.get_session(sessionid)

            pc = self._make_pc()
            self.pcs.add(pc)

            player = HumanPlayer(avatar_session)

            @pc.on("connectionstatechange")
            async def on_connectionstatechange():
                logger.info("Connection state is %s", pc.connectionState)
                if pc.connectionState in ("failed", "closed"):
                    await pc.close()
                    self.pcs.discard(pc)
                    # stop the render/TTS/inference/compose threads before
                    # dropping the session (otherwise they run forever)
                    await asyncio.get_event_loop().run_in_executor(None, player.stop)
                    session_manager.remove_session(sessionid)
            pc.addTrack(player.audio)
            pc.addTrack(player.video)
            _prefer_codecs(pc)

            await pc.setRemoteDescription(offer)
            answer = await pc.createAnswer()
            await pc.setLocalDescription(answer)

            return web.Response(
                content_type="application/json",
                text=json.dumps({
                    "sdp": pc.localDescription.sdp,
                    "type": pc.localDescription.type,
                    "sessionid": sessionid,
                }),
            )
        except Exception as e:
            logger.exception("handle_offer failed:")
            return web.Response(
                content_type="application/json",
                text=json.dumps({"code": -1, "msg": str(e)}),
            )

    async def handle_rtcpush(self, push_url: str, sessionid: str) -> None:
        """Dial out to a WHIP endpoint and push this session's media."""
        if not session_manager.has_session(sessionid):
            await session_manager.create_session({}, sessionid)
        avatar_session = session_manager.get_session(sessionid)

        pc = self._make_pc()
        self.pcs.add(pc)
        player = HumanPlayer(avatar_session)
        pc.addTrack(player.audio)
        pc.addTrack(player.video)

        await pc.setLocalDescription(await pc.createOffer())
        async with aiohttp.ClientSession() as http:
            async with http.post(push_url, data=pc.localDescription.sdp,
                                 headers={"Content-Type": "application/sdp"}) as resp:
                answer_sdp = await resp.text()
        await pc.setRemoteDescription(RTCSessionDescription(sdp=answer_sdp, type="answer"))
        logger.info("rtcpush connected: %s session %s", push_url, sessionid)

    async def shutdown(self) -> None:
        await asyncio.gather(*(pc.close() for pc in self.pcs), return_exceptions=True)
        self.pcs.clear()
