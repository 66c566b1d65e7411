"""Self-contained interactive web viewer for trained splats (counterpart
of lichtfeld_studio_tpu/render/web_viewer.py: the same template, layout and
sampling, so both packages write the same bytes for the same model and
seed). The export computes on the host only, in numpy: it asks for no GPU.

The reference ships an OpenGL/ImGui desktop viewer (src/visualizer/,
src/rendering/ — ~15 kLoC of GLFW/GLSL/CUDA-interop). A training box is
headless, so the interactive story here is: export a single HTML file with
an embedded WebGL2 3D-gaussian renderer (instanced quads + conic fragment
shader, 16-bit counting-sort depth ordering that handles >=1M splats,
orbit/pan/zoom controls), plus degree-1 spherical-harmonics view-dependent
color evaluated in the vertex shader (kernel_utils.cuh:15-40 basis
convention) and the reference viewer's render modes (keys 1-4: RGB, depth
colormap, point cloud, split RGB|depth — src/rendering/ RenderMode parity).
Open it in any browser — no server, no dependencies.

Splat data is embedded base64 (~25 B/splat: f32 pos, u8 rgba, f16 cov3d,
i8 SH1 coeffs) and capped at `max_points` by opacity-weighted importance."""

from __future__ import annotations

import base64
import json
import struct
from pathlib import Path

import numpy as np


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>LichtFeld-Studio-TPU viewer</title>
<style>
 html,body{margin:0;height:100%;overflow:hidden;background:#111;font-family:monospace}
 #c{width:100%;height:100%;display:block}
 #hud{position:fixed;top:8px;left:10px;color:#9f9;font-size:12px;user-select:none}
 #scene{position:fixed;top:8px;right:10px;color:#ddd;font-size:12px;background:#0008;
   padding:6px 10px;border-radius:4px;user-select:none}
 #scene label{display:block;cursor:pointer}
</style></head>
<body><canvas id="c"></canvas><div id="hud"></div><div id="scene"></div>
<script>
"use strict";
const META = __META__;
const RAW = Uint8Array.from(atob("__DATA__"), c=>c.charCodeAt(0));
const N = META.count;
// layout per splat (little endian): pos f32x3, rgba u8x4, cov3d f16x6, sh1 i8x9
const STRIDE = 12+4+12+9;
const dv = new DataView(RAW.buffer);
const pos = new Float32Array(N*3), col = new Uint8Array(N*4), cov = new Float32Array(N*6);
const sh1 = new Float32Array(N*9);
const SH1S = META.sh1_scale;
function f16(u){const s=(u&0x8000)?-1:1,e=(u>>10)&0x1f,m=u&0x3ff;
 if(e===0)return s*m*Math.pow(2,-24); if(e===31)return m?NaN:s*Infinity;
 return s*(1+m/1024)*Math.pow(2,e-15);}
for(let i=0;i<N;i++){const o=i*STRIDE;
 pos[i*3]=dv.getFloat32(o,true);pos[i*3+1]=dv.getFloat32(o+4,true);pos[i*3+2]=dv.getFloat32(o+8,true);
 col[i*4]=RAW[o+12];col[i*4+1]=RAW[o+13];col[i*4+2]=RAW[o+14];col[i*4+3]=RAW[o+15];
 for(let k=0;k<6;k++)cov[i*6+k]=f16(dv.getUint16(o+16+2*k,true));
 for(let k=0;k<9;k++)sh1[i*9+k]=dv.getInt8(o+28+k)*SH1S;}

const canvas=document.getElementById("c");
const gl=canvas.getContext("webgl2",{antialias:false});
const VS=`#version 300 es
layout(location=0) in vec2 corner;
layout(location=1) in vec3 a_pos;
layout(location=2) in vec4 a_col;
layout(location=3) in vec3 a_covA; // xx xy xz
layout(location=4) in vec3 a_covB; // yy yz zz
layout(location=5) in vec3 a_sh1a; // rgb of basis -C1*y
layout(location=6) in vec3 a_sh1b; // rgb of basis  C1*z
layout(location=7) in vec3 a_sh1c; // rgb of basis -C1*x
uniform mat4 view; uniform float fx,fy; uniform vec2 vp; uniform vec3 eye;
uniform int mode; // 0 rgb, 1 depth, 2 point cloud, 3 split rgb|depth
uniform int useCrop; uniform vec3 cropMin, cropMax;
out vec4 v_col; out vec2 v_d; out vec3 v_conic; out float v_z;
void main(){
 if(useCrop==1 && (any(lessThan(a_pos,cropMin))||any(greaterThan(a_pos,cropMax)))){
  gl_Position=vec4(0,0,2,1); return; }
 vec4 pc = view * vec4(a_pos,1.0);
 if(pc.z < 0.05){ gl_Position=vec4(0,0,2,1); return; }
 float z=pc.z; v_z=z;
 mat3 S=mat3(a_covA.x,a_covA.y,a_covA.z, a_covA.y,a_covB.x,a_covB.y, a_covA.z,a_covB.y,a_covB.z);
 mat3 W=mat3(view); // upper 3x3 (column major)
 mat3 J=mat3(fx/z,0.0,0.0, 0.0,fy/z,0.0, -fx*pc.x/(z*z),-fy*pc.y/(z*z),0.0);
 mat3 C=J*transpose(W)*S*W*transpose(J);
 float cxx=C[0][0]+0.3, cyy=C[1][1]+0.3, cxy=C[0][1];
 float det=cxx*cyy-cxy*cxy; if(det<1e-9){ gl_Position=vec4(0,0,2,1); return; }
 v_conic=vec3(cyy,-cxy,cxx)/det;
 float r=3.0*sqrt(max(cxx,cyy));
 if(mode==2){ r=2.0; } // point-cloud: fixed 2px sprite
 vec2 center=vec2(fx*pc.x/z, fy*pc.y/z);
 vec2 d=corner*r;
 v_d=d;
 // degree-1 SH view dependence (kernel_utils.cuh basis: -C1 y, C1 z, -C1 x)
 vec3 dir=normalize(a_pos-eye);
 const float C1=0.4886025119;
 vec3 rgb=a_col.rgb/255.0 + (-C1*dir.y)*a_sh1a + (C1*dir.z)*a_sh1b + (-C1*dir.x)*a_sh1c;
 v_col=vec4(max(rgb,vec3(0.0)), a_col.a/255.0);
 vec2 ndc=(center+d)/ (0.5*vp);
 gl_Position=vec4(ndc.x, -ndc.y, z/1e4, 1.0);
}`;
const FS=`#version 300 es
precision highp float;
in vec4 v_col; in vec2 v_d; in vec3 v_conic; in float v_z; out vec4 frag;
uniform int mode; uniform float znear,zfar,splitx;
vec3 turbo(float t){ // polynomial fit of the Turbo colormap
 t=clamp(t,0.0,1.0);
 return clamp(vec3(
  0.1357+t*(4.5974+t*(-42.3277+t*(130.5887+t*(-150.5666+t*58.1375)))),
  0.0914+t*(2.1856+t*(4.8052+t*(-14.0195+t*(4.2109+t*2.7747)))),
  0.1067+t*(12.5925+t*(-60.1097+t*(109.0745+t*(-88.5066+t*26.8183))))),0.0,1.0);
}
void main(){
 bool depthHalf = (mode==1) || (mode==3 && gl_FragCoord.x > splitx);
 if(mode==2){ // point cloud: opaque sprites, no falloff
  frag=vec4(depthHalf?turbo(1.0-(v_z-znear)/(zfar-znear)):v_col.rgb,1.0); return; }
 float p=0.5*(v_conic.x*v_d.x*v_d.x+v_conic.z*v_d.y*v_d.y)+v_conic.y*v_d.x*v_d.y;
 if(p<0.0) discard;
 float a=v_col.a*exp(-p);
 if(a<0.0039) discard;
 vec3 rgb = depthHalf ? turbo(1.0-(v_z-znear)/(zfar-znear)) : v_col.rgb;
 frag=vec4(rgb*a, a);
}`;
function sh(t,s){const o=gl.createShader(t);gl.shaderSource(o,s);gl.compileShader(o);
 if(!gl.getShaderParameter(o,gl.COMPILE_STATUS))throw gl.getShaderInfoLog(o);return o;}
function mkProg(vs,fs){const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));
 gl.linkProgram(p);if(!gl.getProgramParameter(p,gl.LINK_STATUS))throw gl.getProgramInfoLog(p);return p;}
const prog=mkProg(VS,FS);
gl.useProgram(prog);

// line-overlay program (axes / grid / crop box / camera frustums — the
// reference's axes_renderer / grid_renderer / bbox_renderer /
// camera_frustum_renderer, src/rendering/)
const LVS=`#version 300 es
layout(location=0) in vec3 p; layout(location=1) in vec3 c;
uniform mat4 view; uniform float fx,fy; uniform vec2 vp; out vec3 v_c;
void main(){ v_c=c; vec4 pc=view*vec4(p,1.0);
 if(pc.z<0.05){ gl_Position=vec4(0,0,2,1); return; }
 vec2 ndc=vec2(fx*pc.x/pc.z, fy*pc.y/pc.z)/(0.5*vp);
 gl_Position=vec4(ndc.x,-ndc.y,pc.z/1e4,1.0);}`;
const LFS=`#version 300 es
precision highp float; in vec3 v_c; uniform float opac; out vec4 frag;
void main(){ frag=vec4(v_c*opac, opac); }`;
const lprog=mkProg(LVS,LFS);
const lbuf=gl.createBuffer(), lcbuf=gl.createBuffer();
function drawLines(verts, cols, opacity){
 gl.useProgram(lprog);
 gl.bindBuffer(gl.ARRAY_BUFFER,lbuf);gl.bufferData(gl.ARRAY_BUFFER,verts,gl.DYNAMIC_DRAW);
 gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,3,gl.FLOAT,false,0,0);gl.vertexAttribDivisor(0,0);
 gl.bindBuffer(gl.ARRAY_BUFFER,lcbuf);gl.bufferData(gl.ARRAY_BUFFER,cols,gl.DYNAMIC_DRAW);
 gl.enableVertexAttribArray(1);gl.vertexAttribPointer(1,3,gl.FLOAT,false,0,0);gl.vertexAttribDivisor(1,0);
 gl.uniform1f(gl.getUniformLocation(lprog,"opac"),opacity);
 gl.drawArrays(gl.LINES,0,verts.length/3);
 // restore the splat program's loc-0 quad binding (shared attribute slot)
 gl.bindBuffer(gl.ARRAY_BUFFER,qb);
 gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,2,gl.FLOAT,false,0,0);
 gl.useProgram(prog);}

const quad=new Float32Array([-1,-1, 1,-1, -1,1, 1,1]);
const qb=gl.createBuffer();gl.bindBuffer(gl.ARRAY_BUFFER,qb);gl.bufferData(gl.ARRAY_BUFFER,quad,gl.STATIC_DRAW);
gl.enableVertexAttribArray(0);gl.vertexAttribPointer(0,2,gl.FLOAT,false,0,0);

// sorted instance buffers (rewritten per re-sort, not per frame)
const bufs=[];for(let i=0;i<7;i++)bufs.push(gl.createBuffer());
const spos=new Float32Array(N*3), scol=new Uint8Array(N*4);
const scovA=new Float32Array(N*3), scovB=new Float32Array(N*3);
const ssh=[new Float32Array(N*3),new Float32Array(N*3),new Float32Array(N*3)];
function bindInst(buf, loc, size, type, norm){gl.bindBuffer(gl.ARRAY_BUFFER,buf);
 gl.enableVertexAttribArray(loc);gl.vertexAttribPointer(loc,size,type,norm,0,0);gl.vertexAttribDivisor(loc,1);}

gl.enable(gl.BLEND);
gl.blendFunc(gl.ONE, gl.ONE_MINUS_SRC_ALPHA);
gl.disable(gl.DEPTH_TEST);

// camera state
let center=META.center, radius=META.radius;
let theta=0.5, phi=0.3, dist=radius*2.2, panX=0, panY=0;
const hud=document.getElementById("hud");
let drag=null;
canvas.addEventListener("mousedown",e=>{drag={x:e.clientX,y:e.clientY,btn:e.button,shift:e.shiftKey};});
window.addEventListener("mouseup",()=>drag=null);
window.addEventListener("mousemove",e=>{if(!drag)return;
 const dx=e.clientX-drag.x, dy=e.clientY-drag.y; drag.x=e.clientX;drag.y=e.clientY;
 if(drag.btn===0&&!drag.shift){theta+=dx*0.005;phi=Math.max(-1.5,Math.min(1.5,phi+dy*0.005));}
 else{panX-=dx*dist*0.001;panY-=dy*dist*0.001;}});
canvas.addEventListener("wheel",e=>{dist*=Math.exp(e.deltaY*0.001);e.preventDefault();},{passive:false});
canvas.addEventListener("contextmenu",e=>e.preventDefault());
// render modes (reference viewer render_mode parity: RGB / D / point cloud / split)
let mode=0; const MODES=["rgb","depth","points","split rgb|depth"];
// overlay + tool state (reference rendering_manager.hpp settings:
// show_coord_axes / show_grid / show_camera_frustums / crop box show+use)
let showAxes=false, showGrid=false, showFrustums=false;
let showCrop=false, useCrop=false, cropAxis=0;
// crop box initialized to the 5%-95% extent of the scene
const bmin=META.bbox_min.slice(), bmax=META.bbox_max.slice();
const cropLo=bmin.slice(), cropHi=bmax.slice();
window.addEventListener("keydown",e=>{
 const step=0.05*(bmax[cropAxis]-bmin[cropAxis]);
 if(e.key==="1")mode=0; else if(e.key==="2")mode=1;
 else if(e.key==="3")mode=2; else if(e.key==="4")mode=3;
 else if(e.key==="a")showAxes=!showAxes;
 else if(e.key==="g")showGrid=!showGrid;
 else if(e.key==="f")showFrustums=!showFrustums;
 else if(e.key==="c")showCrop=!showCrop;
 else if(e.key==="x")useCrop=!useCrop;
 else if(e.key==="z")cropAxis=(cropAxis+1)%3;
 else if(e.key==="[")cropLo[cropAxis]=Math.min(cropLo[cropAxis]+step,cropHi[cropAxis]);
 else if(e.key==="{")cropLo[cropAxis]-=step;
 else if(e.key==="]")cropHi[cropAxis]=Math.max(cropHi[cropAxis]-step,cropLo[cropAxis]);
 else if(e.key==="}")cropHi[cropAxis]+=step;
 else if(e.key==="r"){for(let k=0;k<3;k++){cropLo[k]=bmin[k];cropHi[k]=bmax[k];}}});

// --- overlay geometry ------------------------------------------------------
function axesLines(){ // RGB = XYZ, axes_size scaled to the scene
 const s=META.radius, c=center;
 return {v:new Float32Array([c[0],c[1],c[2], c[0]+s,c[1],c[2],
   c[0],c[1],c[2], c[0],c[1]+s,c[2],  c[0],c[1],c[2], c[0],c[1],c[2]+s]),
  c:new Float32Array([1,0.2,0.2, 1,0.2,0.2, 0.2,1,0.2, 0.2,1,0.2, 0.3,0.5,1, 0.3,0.5,1])};}
function gridLines(){ // XZ ground plane (reference grid_plane=1), 2x scene radius
 const s=2*META.radius, c=center, y=bmax[1], n=10, v=[], col=[];
 for(let i=-n;i<=n;i++){const t=i*s/n;
  v.push(c[0]+t,y,c[2]-s, c[0]+t,y,c[2]+s, c[0]-s,y,c[2]+t, c[0]+s,y,c[2]+t);
  for(let k=0;k<4;k++)col.push(0.5,0.5,0.55);}
 return {v:new Float32Array(v), c:new Float32Array(col)};}
function boxLines(lo,hi,r,g,b){
 const x0=lo[0],y0=lo[1],z0=lo[2],x1=hi[0],y1=hi[1],z1=hi[2];
 const e=[[x0,y0,z0,x1,y0,z0],[x0,y1,z0,x1,y1,z0],[x0,y0,z1,x1,y0,z1],[x0,y1,z1,x1,y1,z1],
  [x0,y0,z0,x0,y1,z0],[x1,y0,z0,x1,y1,z0],[x0,y0,z1,x0,y1,z1],[x1,y0,z1,x1,y1,z1],
  [x0,y0,z0,x0,y0,z1],[x1,y0,z0,x1,y0,z1],[x0,y1,z0,x0,y1,z1],[x1,y1,z0,x1,y1,z1]];
 const v=new Float32Array(e.flat()), col=new Float32Array(24*3);
 for(let i=0;i<24;i++){col[i*3]=r;col[i*3+1]=g;col[i*3+2]=b;}
 return {v:v, c:col};}
const frustumGeo=(()=>{ // dataset camera frustums (camera_frustum_renderer)
 if(!META.frustums || !META.frustums.length) return null;
 const v=[], col=[];
 for(const fr of META.frustums){ // fr = 15 floats: eye, 4 image-plane corners
  const E=fr.slice(0,3), C=[fr.slice(3,6),fr.slice(6,9),fr.slice(9,12),fr.slice(12,15)];
  for(let k=0;k<4;k++){v.push(...E,...C[k]); v.push(...C[k],...C[(k+1)%4]);}
  for(let k=0;k<16;k++)col.push(1.0,0.8,0.2);}
 return {v:new Float32Array(v), c:new Float32Array(col)};})();

// scene graph: per-model visibility (reference SceneManager node toggles,
// src/visualizer/scene/) — hidden models drop out of the sort entirely
const MODELS=META.models&&META.models.length?META.models:[{name:"model",start:0,count:N}];
const modelOf=new Uint8Array(N);
MODELS.forEach((m,mi)=>{modelOf.fill(mi,m.start,m.start+m.count);});
const visible=MODELS.map(()=>true);
let drawCount=N;
if(MODELS.length>1){const panel=document.getElementById("scene");
 MODELS.forEach((m,mi)=>{const l=document.createElement("label");
  const cb=document.createElement("input");cb.type="checkbox";cb.checked=true;
  cb.onchange=()=>{visible[mi]=cb.checked;lastDir=[9,9,9];};
  l.appendChild(cb);l.appendChild(document.createTextNode(` ${m.name} (${m.count})`));
  panel.appendChild(l);});}

// 16-bit counting sort over quantized view depth: O(N) per re-sort, scales
// to millions of splats where Array.prototype.sort thrashes
const order=new Uint32Array(N), keys=new Uint16Array(N), hist=new Uint32Array(65537);
let lastDir=[0,0,0];
function resort(R){
 let lo=1e30,hi=-1e30;
 const zx=R[2][0],zy=R[2][1],zz=R[2][2];
 const zf=new Float32Array(N);
 for(let i=0;i<N;i++){const z=zx*pos[i*3]+zy*pos[i*3+1]+zz*pos[i*3+2];zf[i]=z;
  if(z<lo)lo=z; if(z>hi)hi=z;}
 const s=65535/Math.max(hi-lo,1e-9);
 hist.fill(0); let M=0;
 for(let i=0;i<N;i++){if(!visible[modelOf[i]]){keys[i]=65535;continue;}
  const k=(65535-((zf[i]-lo)*s))|0;keys[i]=k;hist[k+1]++;M++;}
 for(let k=1;k<=65536;k++)hist[k]+=hist[k-1];
 for(let i=0;i<N;i++){if(!visible[modelOf[i]])continue;order[hist[keys[i]]++]=i;}  // back-to-front
 drawCount=M;
 for(let k=0;k<M;k++){const i=order[k];
  spos[k*3]=pos[i*3];spos[k*3+1]=pos[i*3+1];spos[k*3+2]=pos[i*3+2];
  scol[k*4]=col[i*4];scol[k*4+1]=col[i*4+1];scol[k*4+2]=col[i*4+2];scol[k*4+3]=col[i*4+3];
  scovA[k*3]=cov[i*6];scovA[k*3+1]=cov[i*6+1];scovA[k*3+2]=cov[i*6+2];
  scovB[k*3]=cov[i*6+3];scovB[k*3+1]=cov[i*6+4];scovB[k*3+2]=cov[i*6+5];
  for(let c=0;c<3;c++){ssh[c][k*3]=sh1[i*9+c*3];ssh[c][k*3+1]=sh1[i*9+c*3+1];ssh[c][k*3+2]=sh1[i*9+c*3+2];}}
 gl.bindBuffer(gl.ARRAY_BUFFER,bufs[0]);gl.bufferData(gl.ARRAY_BUFFER,spos,gl.DYNAMIC_DRAW);
 gl.bindBuffer(gl.ARRAY_BUFFER,bufs[1]);gl.bufferData(gl.ARRAY_BUFFER,scol,gl.DYNAMIC_DRAW);
 gl.bindBuffer(gl.ARRAY_BUFFER,bufs[2]);gl.bufferData(gl.ARRAY_BUFFER,scovA,gl.DYNAMIC_DRAW);
 gl.bindBuffer(gl.ARRAY_BUFFER,bufs[3]);gl.bufferData(gl.ARRAY_BUFFER,scovB,gl.DYNAMIC_DRAW);
 for(let c=0;c<3;c++){gl.bindBuffer(gl.ARRAY_BUFFER,bufs[4+c]);gl.bufferData(gl.ARRAY_BUFFER,ssh[c],gl.DYNAMIC_DRAW);}
}

let frames=0,lastT=performance.now();
function draw(){
 const w=canvas.clientWidth*devicePixelRatio, h=canvas.clientHeight*devicePixelRatio;
 if(canvas.width!==w||canvas.height!==h){canvas.width=w;canvas.height=h;}
 gl.viewport(0,0,w,h);
 gl.clearColor(0.05,0.05,0.08,1);gl.clear(gl.COLOR_BUFFER_BIT);
 const ct=Math.cos(theta),st=Math.sin(theta),cp=Math.cos(phi),sp=Math.sin(phi);
 const eye=[center[0]+dist*cp*st+panX, center[1]+dist*sp+panY, center[2]-dist*cp*ct];
 const tgt=[center[0]+panX, center[1]+panY, center[2]];
 // look-at (camera +z forward, +y down)
 let f=[tgt[0]-eye[0],tgt[1]-eye[1],tgt[2]-eye[2]];
 let fl=Math.hypot(...f);f=f.map(v=>v/fl);
 let up=[0,-1,0];
 let r=[f[1]*up[2]-f[2]*up[1], f[2]*up[0]-f[0]*up[2], f[0]*up[1]-f[1]*up[0]];
 let rl=Math.hypot(...r);r=r.map(v=>v/rl);
 let d=[f[1]*r[2]-f[2]*r[1], f[2]*r[0]-f[0]*r[2], f[0]*r[1]-f[1]*r[0]];
 const R=[r,d,f]; // rows
 const t=[-(R[0][0]*eye[0]+R[0][1]*eye[1]+R[0][2]*eye[2]),
          -(R[1][0]*eye[0]+R[1][1]*eye[1]+R[1][2]*eye[2]),
          -(R[2][0]*eye[0]+R[2][1]*eye[1]+R[2][2]*eye[2])];
 // column-major mat4
 const V=[R[0][0],R[1][0],R[2][0],0, R[0][1],R[1][1],R[2][1],0, R[0][2],R[1][2],R[2][2],0, t[0],t[1],t[2],1];
 // re-sort only when the view direction moved enough (back-to-front OVER)
 const moved=Math.abs(f[0]-lastDir[0])+Math.abs(f[1]-lastDir[1])+Math.abs(f[2]-lastDir[2]);
 if(moved>0.01){resort(R);lastDir=f.slice();}
 bindInst(bufs[0],1,3,gl.FLOAT,false);
 gl.bindBuffer(gl.ARRAY_BUFFER,bufs[1]);
 gl.enableVertexAttribArray(2);gl.vertexAttribPointer(2,4,gl.UNSIGNED_BYTE,false,0,0);gl.vertexAttribDivisor(2,1);
 bindInst(bufs[2],3,3,gl.FLOAT,false);
 bindInst(bufs[3],4,3,gl.FLOAT,false);
 bindInst(bufs[4],5,3,gl.FLOAT,false);
 bindInst(bufs[5],6,3,gl.FLOAT,false);
 bindInst(bufs[6],7,3,gl.FLOAT,false);
 const f_px=0.8*w;
 gl.uniformMatrix4fv(gl.getUniformLocation(prog,"view"),false,new Float32Array(V));
 gl.uniform1f(gl.getUniformLocation(prog,"fx"),f_px);
 gl.uniform1f(gl.getUniformLocation(prog,"fy"),f_px);
 gl.uniform2f(gl.getUniformLocation(prog,"vp"),w,h);
 gl.uniform3f(gl.getUniformLocation(prog,"eye"),eye[0],eye[1],eye[2]);
 gl.uniform1i(gl.getUniformLocation(prog,"mode"),mode);
 gl.uniform1f(gl.getUniformLocation(prog,"znear"),Math.max(dist-2.0*radius,0.05));
 gl.uniform1f(gl.getUniformLocation(prog,"zfar"),dist+2.0*radius);
 gl.uniform1f(gl.getUniformLocation(prog,"splitx"),0.5*w);
 gl.uniform1i(gl.getUniformLocation(prog,"useCrop"),useCrop?1:0);
 gl.uniform3f(gl.getUniformLocation(prog,"cropMin"),cropLo[0],cropLo[1],cropLo[2]);
 gl.uniform3f(gl.getUniformLocation(prog,"cropMax"),cropHi[0],cropHi[1],cropHi[2]);
 gl.drawArraysInstanced(gl.TRIANGLE_STRIP,0,4,drawCount);
 // overlays on top (the line program shares view/fx/fy/vp uniforms)
 if(showAxes||showGrid||showFrustums||showCrop){
  gl.useProgram(lprog);
  gl.uniformMatrix4fv(gl.getUniformLocation(lprog,"view"),false,new Float32Array(V));
  gl.uniform1f(gl.getUniformLocation(lprog,"fx"),f_px);
  gl.uniform1f(gl.getUniformLocation(lprog,"fy"),f_px);
  gl.uniform2f(gl.getUniformLocation(lprog,"vp"),w,h);
  gl.useProgram(prog);
  if(showGrid){const g0=gridLines();drawLines(g0.v,g0.c,0.5);}
  if(showAxes){const a0=axesLines();drawLines(a0.v,a0.c,1.0);}
  if(showFrustums&&frustumGeo)drawLines(frustumGeo.v,frustumGeo.c,0.8);
  if(showCrop){const b0=boxLines(cropLo,cropHi,1.0,0.9,0.1);drawLines(b0.v,b0.c,1.0);}}
 frames++;const now=performance.now();
 if(now-lastT>500){
  const crop=showCrop?` | crop axis=${"XYZ"[cropAxis]}${useCrop?" ON":""} ([ ] { } faces, z axis, x apply, r reset)`:"";
  hud.textContent=`${drawCount}/${META.count} splats | ${(frames*1000/(now-lastT)).toFixed(0)} fps | ${MODES[mode]} | drag orbit, shift-drag pan, wheel zoom, 1-4 mode, a axes, g grid, f cams, c crop${crop}`;frames=0;lastT=now;}
 requestAnimationFrame(draw);
}
requestAnimationFrame(draw);
</script></body></html>
"""


def _f16_bits(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float16).view(np.uint16)


def _cov3d_np(quat: np.ndarray, log_scale: np.ndarray) -> np.ndarray:
    """Host-side quat/scale -> 3x3 covariance (same math as
    ops/gaussians.quat_scale_to_cov3d, kept in numpy so viewer export never
    round-trips through the accelerator)."""
    q = quat / np.maximum(np.linalg.norm(quat, axis=1, keepdims=True), 1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        axis=1,
    ).reshape(-1, 3, 3)
    M = R * np.exp(log_scale)[:, None, :]
    return M @ M.transpose(0, 2, 1)


def _frustum_lines(cameras, scale: float) -> list[list[float]]:
    """Per-camera [eye xyz, 4 image-plane corner xyz] (15 floats) for the
    viewer's frustum overlay (reference camera_frustum_renderer.cpp;
    camera_frustum_scale default 0.25, rendering_manager.hpp:75)."""
    out = []
    for cam in cameras:
        eye = np.asarray(cam.cam_position, np.float64)
        c2w_r = np.asarray(cam.R, np.float64).T  # columns = cam axes in world
        hx = np.tan(0.5 * cam.fov_x()) * scale
        hy = np.tan(0.5 * cam.fov_y()) * scale
        corners = []
        for sx, sy in ((-1, -1), (1, -1), (1, 1), (-1, 1)):
            p = eye + c2w_r @ np.array([sx * hx, sy * hy, scale])
            corners.extend(float(v) for v in p)
        out.append([float(v) for v in eye] + corners)
    return out


def _model_arrays(pc, max_points: int, seed: int):
    """One model's embed arrays (means, rgb, opac, cov6, shn), importance-
    sampled down to max_points."""
    n = pc.size
    means = pc.means.astype(np.float32, copy=False)
    opac = np.clip(
        np.round(255.0 / (1.0 + np.exp(-pc.opacity[:, 0].astype(np.float64)))), 0, 255
    ).astype(np.uint8)
    sh0 = pc.sh0[:, 0, :]
    rgb = np.clip((0.5 + 0.28209479177387814 * sh0) * 255.0, 0, 255).astype(np.uint8)
    # degree-1 coefficients [n, 3(coeff), 3(rgb)] (shN rows 0-2); zero-pad
    # degree-0 models so the viewer layout is uniform
    shn = np.zeros((n, 3, 3), np.float32)
    k1 = min(3, pc.shN.shape[1])
    shn[:, :k1, :] = pc.shN[:, :k1, :]

    cov = _cov3d_np(pc.rotation, pc.scaling)
    cov6 = np.stack(
        [cov[:, 0, 0], cov[:, 0, 1], cov[:, 0, 2], cov[:, 1, 1], cov[:, 1, 2], cov[:, 2, 2]],
        axis=1,
    )

    if n > max_points:
        w = opac.astype(np.float64) + 1.0
        sel = np.random.default_rng(seed).choice(n, max_points, replace=False, p=w / w.sum())
        means, rgb, opac, cov6, shn = means[sel], rgb[sel], opac[sel], cov6[sel], shn[sel]
    return means, rgb, opac, cov6, shn


def export_html(
    splats,
    output: str | Path,
    max_points: int = 1_000_000,
    seed: int = 0,
    cameras=None,
) -> Path:
    """Write a standalone interactive HTML viewer for one or more splat
    models. View-dependent color up to SH degree 1 (int8-quantized
    coefficients); `max_points` caps the embed size by opacity-weighted
    importance (shared proportionally across models). Overlay tools (crop
    box, axes, grid, camera frustums) mirror the reference viewer's
    rendering settings (rendering_manager.hpp:49-75, crop_box_panel.hpp:
    15-16); pass the dataset `cameras` to enable the frustum overlay.

    `splats` is a SplatData (tensors on any device; pulled to the host
    once), a host
    PointCloud, or — the SceneManager analogue (reference multi-PLY scene
    graph, src/visualizer/scene/scene_manager.cpp) — a list of
    (name, SplatData|PointCloud) pairs; multi-model exports get a
    per-model visibility panel in the viewer."""
    from lichtfeld_studio_tpu_torch.core.point_cloud import PointCloud

    def to_pc(s):
        return s if isinstance(s, PointCloud) else s.to_point_cloud()

    if isinstance(splats, (list, tuple)) and splats and isinstance(splats[0], (list, tuple)):
        named = [(str(name), to_pc(s)) for name, s in splats]
    else:
        named = [("model", to_pc(splats))]

    total = sum(pc.size for _, pc in named)
    parts, models_meta, start = [], [], 0
    for name, pc in named:
        cap = max(1, int(max_points * pc.size / max(total, 1)))
        arrs = _model_arrays(pc, cap, seed)
        cnt = arrs[0].shape[0]
        models_meta.append({"name": name, "start": start, "count": cnt})
        parts.append(arrs)
        start += cnt
    means = np.concatenate([p[0] for p in parts])
    rgb = np.concatenate([p[1] for p in parts])
    opac = np.concatenate([p[2] for p in parts])
    cov6 = np.concatenate([p[3] for p in parts])
    shn = np.concatenate([p[4] for p in parts])
    n = means.shape[0]

    sh1_scale = float(max(np.abs(shn).max(), 1e-6)) / 127.0
    sh1_q = np.clip(np.round(shn / sh1_scale), -127, 127).astype(np.int8)
    # JS layout wants [coeff c][xyz of coeff]: store as (c0_rgb, c1_rgb, c2_rgb)
    sh1_bytes = sh1_q.transpose(0, 1, 2).reshape(n, 9)

    stride = 12 + 4 + 12 + 9
    buf = np.zeros((n, stride), np.uint8)
    buf[:, 0:12] = np.ascontiguousarray(means.astype("<f4")).view(np.uint8).reshape(n, 12)
    buf[:, 12:15] = rgb
    buf[:, 15] = opac
    buf[:, 16:28] = (
        np.ascontiguousarray(_f16_bits(cov6.astype(np.float32)).astype("<u2"))
        .view(np.uint8)
        .reshape(n, 12)
    )
    buf[:, 28:37] = np.ascontiguousarray(sh1_bytes).view(np.uint8)

    center = means.mean(axis=0)
    radius = float(np.percentile(np.linalg.norm(means - center, axis=1), 90))
    # robust scene bounds for the crop-box tool (5-95 percentile per axis)
    bbox_min = np.percentile(means, 5, axis=0)
    bbox_max = np.percentile(means, 95, axis=0)
    meta = {
        "count": n,
        "center": [float(c) for c in center],
        "radius": max(radius, 1e-3),
        "sh1_scale": sh1_scale,
        "bbox_min": [float(v) for v in bbox_min],
        "bbox_max": [float(v) for v in bbox_max],
        "models": models_meta,
        "frustums": _frustum_lines(cameras, 0.25 * max(radius, 1e-3))
        if cameras
        else [],
    }

    html = _HTML_TEMPLATE.replace("__META__", json.dumps(meta)).replace(
        "__DATA__", base64.b64encode(buf.tobytes()).decode()
    )
    output = Path(output)
    output.write_text(html)
    return output
